#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--noisy] [--profile-frames N]

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, then drives the port's main path once
through its entry points: the committed exp/minilib system (20k words, 1M-state
HCLG, TDNN-F) decodes its 256-utterance held-out set, synthesised from a seed,
at max_active=1024, batch=128, beam=14, acoustic_scale=1.0, with the host-clock
seconds of each stage.  Then the GMM serving path: the committed triphone
tri.mdl, read by the port's own reader, decodes the same 256 utterances as
one padded batch through recipes/decode.decode_dataset at DecodeOptions()
(beam 16, max_active 7000, acoustic_scale 0.1): loglikes through the GMM
kernel, the top-K dense-alpha search.  Then the chain path: chain.mdl on its
split-eps graph chain_hclg.npz decodes the same 256 utterances through
recipes/minilib.decode_and_score_chain (logits at frame-subsampling 3,
max_active=2048, batch=64, beam=14), and 16 of them once more with lattice
records (the split-eps lattice mode), whose rebuilt lattices must give the
decoder's words.  Then rescoring, as the JAX package's bench calls it:
rescore_and_score on the first 64 utterances re-synthesised at noise 400,
max_active=1024, batch 16, lattice beam 8, a full 4-gram estimated from the
synthesised LM text; before, after and oracle WER and the seconds of each
stage, and each utterance's live lattice records against the port's counts
on the CPU (where one differs, the card's search runs once more on loglikes
computed on the CPU, to tell a search fault from acoustic float order).
Then the iVector systems at bench.py's K=2048, B=64: the CE+iVec model
final_ivec.am (decode_and_score(..., use_ivectors=True)) and chain_ivec.mdl
(load_chain_system(..., use_ivectors=True)), features with online iVectors
from final.ie appended.  Then streaming, on 8 utterances spread over the
durations: online/streaming.StreamingTokenDecoder fed the batch features in
32-frame chunks with final.am on hclg.npz (and 30-frame chunks with
chain.mdl on chain_hclg.npz at frame-subsampling 3), whose words must equal
the batch decode's; and online2, the OnlineFeaturePipeline with online
iVectors fed 0.5 s of audio at a time into the streaming decoder with
final_ivec.am.  Then forced alignment: the 600-utterance training set,
synthesised from its seeds, through recipes/minilib.align_training_set with
tri.mdl, with mono.mdl and as the equal alignment (features through the
MFCC kernel, loglikes through the GMM kernel, a training graph per
utterance from the native graph library, built from cpp/wfst.cc, and the
alignment scan with the gather kernel three times a frame), each
utterance's tids held to the port's alignment on the CPU (digests in this
script); any utterance that differs is aligned once more on loglikes
computed on the CPU, on both devices.  Then the gather and GMM kernels at
the alignment's shapes.  Then GMM training: yesno config 1 end to end at
its defaults (recipes/yesno.run_yesno: 31 utterances, flat-start monophones,
20 iterations towards 120 Gaussians, then the unigram decode at WER 0.00),
and minilib stages 3 and 4 on the training set (minilib.train_mono_system:
25 iterations towards 500 Gaussians, 17 alignment passes;
minilib.train_tri_system: the 2,000-leaf tree from the committed mono.mdl
and mono_ali.pkl, 8 iterations towards 4,000 Gaussians), each held to the
port's run on the CPU (Gaussian counts and like/frame, constants in this
script; the tree's leaves as a record), with the seconds of each stage;
and the three kernels at the training shapes (K3 on the flat-start, the
trained mono and tri models and the largest mixture, K1 at the yesno
alignment's shapes, K2 on the yesno waves).  Then bench.py's toy system (recipes/toy.py): 1,024
utterances of 10 s of noise at 16 kHz through the MFCC kernel, a TDNN-F
and the dense search at K = S; its lattice mode on loglikes synthesised
from known sentences, whose lattices' best paths must be the decoder's
words and whose words the CPU's; and the dense StreamingDecoder, whose
words must be the batch decode's.  Then BASELINE config 2 and the five
configs as one pipeline: recipes/run_all.py on yesno (stages 0-80 in a
fresh workdir, every WER line inside tests/test_run_all.py's gates, a
resumed run that skips every stage), train_sat at yesno scale (fMLLR
solved for its speakers at once), LDA+MLLT at minilib scale
(recipes/triphone.train_lda_mllt on the 600 training utterances' statics
from tri.mdl, 2,000 leaves, 40 dimensions, held to the port's CPU run;
then the first 64 held-out utterances decoded before and after
per-utterance fMLLR on an HCLG of the new tree), and the GMM kernel at its
two new depths (K = 48 and 88) on those models' features (these two after
sequence training, while that HCLG builds in its own process).  Then sequence
training: flat-start LF-MMI (recipes/chain.train_chain_e2e) on yesno as the
JAX package's tests run it and on 150 of the training utterances at full width
(one step's loss held to the CPU's); semi-supervised LF-MMI
(recipes/semisup) on yesno from two initial draws and with 32 + 32
training utterances on chain.mdl, its lattice numerators from the
token-sparse lattice records on chain_hclg.npz, each held to num ≤ den;
MMI by EBW (recipes/mmi.train_mmi) on yesno and with tri.mdl on 32
training utterances, the first iteration's statistics and update held to
the CPU's from the same lattices, and the GMM kernel on the updated
models; nnet3 sMBR / MMI (models/discriminative) on the two-path toy and
of final.am on 32 training utterances, its gradient held to the CPU's.
Then what users read from a decode (lattice_outputs): tri.mdl decodes 64
held-out utterances at noise 400 with lattices (DecodeOptions(), K1, K2,
K3), once determinized by the native library of cpp/lattice.cc, which the
Python determinization must equal on every lattice, each lattice's best
path the decoder's words; the LM-weight sweep, MBR, CTM with confidences,
frame posteriors, a compact-lattice archive read back, decode_biglm with
the identity and from the pruned trigram to the rescore phase's 4-gram,
and an LSTMP RNNLM over the 20k words trained one epoch of 10,000
sentences on the card (held to the CPU) rescoring 10-best lists.  Then the
remaining nnet3
architectures (architectures, architectures_parity, stream_lstm): the JAX
package's TDNN-LSTM, TDNN-attention (features through K2) and CNN-TDNN-F
(40-bin filterbank) at its factories' widths, trained 2 epochs on the 600
training utterances from tri_ali.pkl's labels and decoded on the clean set
through K1 (WER at most 5 %), each with one step and 8 utterances'
loglikes held to the CPU; a BLSTMP, a projected-GRU and a Descriptor-DAG
xconfig model at width 512 and the filterbank and PLP front ends held to
the CPU; and the TDNN-LSTM and CNN-TDNN-F streamed through StreamingAmNnet
into StreamingTokenDecoder on 8 utterances in 0.5 s chunks, whose words
must be the batch decode's.  Then the legacy model families (nnet12): nnet1
(a 2 × 256 sigmoid MLP, frame-shuffled SGD with newbob) and nnet2 (2 × p-norm
512 → 64 on a whitening fixed affine, parallel SGD with model averaging over
a jobs axis) trained on the architectures phase's features of the 600
training utterances and decoded on the clean set through K1 (WER at most
5 %), each family's yesno flow (WER at most 2.0) and one epoch / iteration
held to the CPU.  Last, the command-line tools (cli):
python -m old_kaldi_git_tpu_torch.bin's tools called in-process (add-deltas
also through the module entry in a subprocess, beside them, to the same
bytes).  Its graph is built through
the CLI in a spawned process from the start of the run (prepare-lang on the
minilib lexicon, its L held to the lang bundle's; a unigram ARPA over the 600
training transcripts' words; tree.pkl's tree as a Kaldi file; mkgraph --tree
with tri.mdl).  The first 64 clean held-out utterances as a wave archive go
through compute-mfcc-feats, compute-cmvn-stats, apply-cmvn and add-deltas
(held to compute_utterance_feats), gmm-latgen-faster with tri.mdl at its
defaults, lattice-best-path and compute-wer (words held to the library's
decode_batch, lattice best paths plus the end state's words to the decoder's
words), nnet3-am-init, nnet3-compute and nnet3-latgen-faster with final.am
(held to AmNnet.loglikes_batch and the library decode); 4 of them through
online-wav-gmm-latgen-faster and online2-wav-nnet3-latgen-faster (held to the
library's StreamingDecoder fed the same chunks) and 2 over localhost through
online2-tcp-nnet3-decode-faster on one connection (its final lines held to
the online2-wav tool's words); and compile-train-graphs, gmm-align-compiled,
align-equal-compiled and nnet3-align-compiled on the first 64 training
utterances (tids held to align_batch on the same graphs and loglikes); then
K1 and K3 at the phase's shapes.  Then the second batch of tools
(cli_lattice, on the cli phase's work directory): the 42 of bin/lat_tools.py
and the 24 of bin/util_tools.py, each run once in-process; the six that make
tensors (gmm-decode-faster and gmm-rescore-lattice through K3,
gmm-acc-stats, rnnlm-train, lattice-lmrescore-rnnlm,
ivector-extract-online2) on all 64 utterances, the per-utterance lattice
tools on the first 4 lattices; every output held to the port's library on
the same inputs (words and alignments to decode_batch and to the lattices'
best paths plus end-state words, accumulators to accumulate_corpus on the
card and the CPU, RNNLM rescoring (16 of the lattices) and iVectors card vs CPU, archives
byte for byte), then K3 at the phase's batch.  Then the third batch
(cli_train, on the same work directory): the 54 tools of bin/train_tools.py
not run before, each once in-process, as the Kaldi recipes run them:
train_deltas.sh on the 64 training utterances and tri.mdl's alignments
(tree statistics of two halves summed, questions, a 200-leaf tree, its
model, mix-up, converted alignments, two EM iterations: alignment through
K3 and K1, statistics, sum, re-estimation), train_lda_mllt.sh and
train_sat.sh (LDA, MLLT in the LDA space, fMLLR per speaker, the
Gaussian-posterior path), adaptation with tri.mdl on the 64 held-out
utterances (a regression tree, MLLR and fMLLR per speaker from the best
paths of the cli phase's lattices, the two regtree decoders on its HCLG:
MLLR through K3 a speaker, basis fMLLR, linear VTLN) and fMPE from
lattice-to-mpe-post's posteriors with an offset GMM made by the library;
every output held to the port's library on the same inputs (files byte for
byte, float64 statistics within 1e-9, words equal), then K1 at the
alignment's shapes and K3 at two new packings (the EM model, the
MLLR-adapted tri.mdl).  Then the fourth batch (cli_nnet3): the 21 nnet3 and
chain tools not run before, as train_dnn.py and chain/train.py run them on
the 64 training utterances: features through the feature tools (K2),
tri.mdl's alignments (K3, K1), CE egs (get, shuffle, copy to 2 archives,
merge), one epoch of nnet3-train fine-tuning final.am, compute-prob before
and after, nnet3-combine, nnet3-adjust-priors, nnet3-am-init and the 64
held-out utterances' decode; the phone LM, both chain trees (the biphone
den graph refused as by the JAX tool), the monophone den graph, a chain
TDNN-F at chain.mdl's widths from nnet3-chain-init, chain egs, one epoch of
nnet3-chain-train and its combination; sMBR on final.am's lattices of the
64; every output held to the port's library on the same inputs (archives,
the phone LM and trees byte for byte, models through loglikes and
objectives within 1e-4, the sMBR objective within 1e-5, words equal) and
one chain step to the CPU's.  In the kernels phase K2 is also held on the
mel tables VTLN-warped by 0.9 and 1.1.  Then the last 43 tools: sgmm2
trains an SGMM2 on the 600 training utterances from tri.mdl and
tri_ali.pkl (a 64-Gaussian UBM, 8 EM iterations, a split to 4,000
substates, 3 realignments through K1 on align_tri's graphs; the EM
auxiliary, K1 three times a scanned frame, one iteration's statistics and
8 utterances' loglikes card vs CPU), decodes the 256 clean utterances on
hclg.npz through K1 (WER <= 5 %) and runs the 9 SGMM2 tools on the cli
phase's work directory, each held to the library; cli_spkid runs the 30
speaker-ID tools on a 512-utterance corpus made from a seed (UBMs,
iVector extractor, PLDA scoring of 16 held-out speakers: EER < 0.15,
logistic regression > 0.8 accuracy), files byte for byte the library's;
cli_kws indexes and searches lattice_outputs' 64 noisy lattices with the 4
KWS tools, byte for byte the library's.
--noisy also decodes the set re-synthesised at noise amplitude 400
(the reference's second operating point) with the TDNN, the chain model
and both iVector systems, and lists the utterances with errors.  --profile-frames N puts the first N frames of one
chunk's search under torch.profiler and reports the device-busy share (summed
kernel time over the wall time the same window takes without the profiler,
whose own cost is large) and the kernels that take most of it.

Each phase prints one JSON line.  Any failure — no CUDA device, a kernel that
does not build, launch or agree, a phase out of bounds — ends the run with a
non-zero exit code and without the final line; nothing carries on on the CPU.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import copy
import ctypes
import dataclasses
import json
import multiprocessing
import os
import re
import shutil
import struct
import sys
import tempfile
import time
import zlib

H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores, published peak
H100_TF32_FLOPS = 495e12      # TF32 on the tensor cores, dense, published peak
H100_HBM_BYTES_PER_S = 3.35e12  # published peak
H100_FP64_FLOPS = 34e12       # fp64 outside the tensor cores, published peak
# K3's product needs about 2^-22 relative precision: on the tensor cores that
# is three TF32 products (hi·hi + hi·lo + lo·hi), the least the card could do
# it in
TF32_SPLIT_PRODUCTS = 3

BEAM, MAX_ACTIVE, BATCH, ACOUSTIC_SCALE = 14.0, 1024, 128, 1.0
MAX_WER_PERCENT = 1.0  # the reference decodes this set at 0.07 %
CHAIN_MAX_ACTIVE, CHAIN_BATCH, CHAIN_LATTICE_UTTS = 2048, 64, 16
# bench.py's rescoring call (recipes/minilib.py rescore_and_score defaults)
RESCORE = dict(noise=400.0, full_lm_order=4, compute_oracle=True, num_utts=64)
RESCORE_MAX_ACTIVE, RESCORE_BATCH = 1024, 16
# live lattice records of each of the 64 rescored utterances (by name) as the
# port counts them on the CPU:
# tests/test_torch_lattice.py::test_rescore_recipe_equals_at_the_benchmark_setting
RESCORE_CPU_LIVE_RECORDS = [
    15234, 10665, 22383, 21835, 15390, 10463, 14006, 22691, 22553, 20805, 10528,
    23392, 40058, 14994, 17924, 16184, 20632, 26717, 24281, 11802, 25049, 26346,
    28781, 21051, 19989, 22328, 14009, 24693, 34157, 31977, 29631, 21336, 22356,
    13510, 12296, 17424, 37364, 34436, 18964, 13653, 21544, 10389, 29579, 36022,
    15451, 16636, 26660, 25018, 30300, 31589, 24407, 29603, 25803, 26482, 27312,
    9069, 23652, 26666, 16750, 25132, 13241, 36260, 34545, 12666]
# (the JAX package counts 23,650 on test_0056 where the port counts 23,652:
# the lattice-beam gate is a float comparison, and their front ends and
# TDNNs round differently; on the JAX package's loglikes both keep 23,650:
# tests/test_torch_lattice.py::test_rescore_records_equal_on_the_same_loglikes)
IVEC_MAX_ACTIVE, IVEC_BATCH = 2048, 64  # bench.py's iVector rows
# the four iVector decodes' errors and utterances with errors, the JAX
# package's on the CPU, which the port's CPU words equal word for word:
# tests/test_torch_ivector.py::test_ivector_recipe_words_equal_on_the_held_out_set
IVEC_CPU_ERRORS = {
    "decode_ivec": (2, ["test_0053"]),
    "decode_chain_ivec": (1, ["test_0152"]),
    "decode_ivec_noisy": (64, [
        "test_0014", "test_0028", "test_0045", "test_0072", "test_0117", "test_0120",
        "test_0121", "test_0126", "test_0138", "test_0143", "test_0149", "test_0150",
        "test_0152", "test_0169", "test_0191", "test_0218", "test_0227", "test_0231",
        "test_0237", "test_0239"]),
    "decode_chain_ivec_noisy": (47, [
        "test_0002", "test_0007", "test_0011", "test_0014", "test_0023", "test_0051",
        "test_0055", "test_0064", "test_0072", "test_0081", "test_0083", "test_0085",
        "test_0091", "test_0093", "test_0094", "test_0099", "test_0103", "test_0106",
        "test_0110", "test_0111", "test_0114", "test_0141", "test_0142", "test_0143",
        "test_0146", "test_0152", "test_0157", "test_0160", "test_0168", "test_0169",
        "test_0174", "test_0175", "test_0189", "test_0197", "test_0201", "test_0210",
        "test_0222", "test_0224", "test_0225", "test_0227", "test_0228", "test_0230",
        "test_0238", "test_0246"]),
}
# benchmarks/streaming_bench.py's setting; chain chunks are a multiple of 3
# STREAM_UTTS: 8, cut from 16 for the smoke's time limit (PERF.md §4)
STREAM_UTTS, STREAM_MAX_ACTIVE, STREAM_CHUNK, STREAM_CHAIN_CHUNK = 8, 2048, 32, 30
ONLINE2_CHUNK_SAMPLES = 4000  # 0.5 s at 8 kHz
PIPELINE_TOL = 1e-4  # chunked vs whole-stream features (tests/test_online.py)
# online2's words on the CPU, the port's and the JAX package's:
# tests/test_torch_online.py::test_online2_words_equal_the_jax_package
ONLINE2_CPU_WORDS = {
    "test_0002": "w00448 w13460 w04450 w00019 w01686 w02799",
    "test_0012": ("w00308 w00000 w09655 w05507 w00019 w08306 w01732 w14048 "
                  "w00399 w01480 w01225 w00027 w00000 w00003 w03332 w00001"),
    "test_0019": "w00048 w01069 w15407 w00228 w01647",
    "test_0081": ("w00061 w00000 w00176 w00083 w00002 w00380 w14964 "
                  "w07566 w00002 w02189 w02475 w00000 w00035 w16094 w00547"),
    "test_0092": ("w00023 w00322 w05708 w15721 w09766 w00081 "
                  "w00028 w00324 w00001 w00048 w03822 w00004"),
    "test_0112": ("w03340 w02049 w00008 w00990 w00670 w00096 "
                  "w00004 w00763 w00004 w00000 w03704 w00012"),
    "test_0114": "w00098 w01226 w00878 w00004 w00763",
    "test_0124": ("w04942 w00005 w07859 w00030 w00001 w00006 w02702 "
                  "w00941 w10909 w00072 w00025 w00006 w00176 w00000 w01544"),
    "test_0135": ("w00004 w00191 w03345 w03626 w00056 w00008 w00345 "
                  "w00012 w04727 w01129 w00033 w04070 w00028 w00005"),
    "test_0180": "w00006 w06844 w00291 w04415 w00234 w00828 w00002 w06001",
    "test_0187": "w00010 w18062 w01879 w00911 w00179 w00950 w00471 w01660 w00078 w00014",
    "test_0217": "w00167 w00410 w00003 w01622 w03155 w00304 w01854",
    "test_0227": ("w03106 w00065 w00131 w00031 w00118 w10001 w04329 w08943 "
                  "w00030 w01657 w00008 w01026 w00018 w02383 w00440 w00043"),
    "test_0228": ("w00517 w04089 w11116 w00051 w00062 "
                  "w00004 w00000 w00879 w00810 w03303 w00077"),
    "test_0230": "w16296 w00002 w07813 w12024 w12374 w00548 w01172 w00675 w00003 w12297",
    "test_0253": ("w00004 w15350 w00017 w00005 w05207 w00445 w15999 w10969 "
                  "w00000 w00004 w00002 w06160 w07682 w05743 w05489 w00223"),
}
# the alignment of each of the 600 training utterances (sorted by name) as the
# port computes it on the CPU, as the CRC-32 of its tids (int32, little
# endian), 8 hex digits an utterance, "--------" where it failed:
# tests/test_torch_align.py::test_the_training_set_aligns_as_the_jax_package
# (whose tids equal the JAX package's on the same loglikes, frame for frame)
FAILED_DIGEST = "--------"
ALIGN_CPU_DIGESTS = {
    "align_tri": (
        "152a5217c9d3c24c5df1a7ab246449a71dde9951ab29ddbcce14cc4a7eb62eab7b31bdb9a748d71c"
        "768a20a1e909729166567694314852574e1bff2f661fba5e68a1fabbbb80d50cf0f42e9b1b4d1ac8"
        "11348e84c19e8f8d483fbf687eb5c2b105e78e7fa31572eaa2e175ba6c7359f741a4417a869b6775"
        "0935f6f55b880474cf191f15a7192d4986cd0678b193206064d01aeea6c41c1c492995fe174224e2"
        "c2e5e05971bc2a51e25e2f2047bfa5fcfeef1a737732906f205ef056c215fed96c496d6dae918df4"
        "4058aebb6f42cd9bc4f603736a993f8eac4ad63bda6f89e244c61c5429f29332ccc97cfe993aaf89"
        "c5c63fa43abde8fb15bf21fd7984e63798d09e396ce35c0c370e200e95e89a0ef55d14f7e9b03a38"
        "80a7d2206048c381011119c790354d99be63907f9bdf119147cc607211a7115702720cbc0b4900d8"
        "031a1f03a9405b1ca1b49be5f7234840bc9b0c797111e86fb6f1eacf2dc83637cc65c07d77a243ec"
        "08e4801ecb0cd70e7c264a33af30af09804475ed37e374a99a9958ae690c694d7f24a99f704b010a"
        "0566b1e7c4a94add3920a5dc4c669d036ddccab17e5c0ac140163f93269e781a23d5406a2e8a010a"
        "9c83a1cad6bab390609fa81a1f10179778f01b91999f717738c52ab65656059824ef3bf2d667387e"
        "6899d761b38913b9412673ec1322fc8e9478cbb640205dd3dbac1ea632b706db04d3d3aa0c55864f"
        "4ead1144675713c18bab85220a631c1befe99c5b28f7d6d156a269c7ada662177c083aac824969b1"
        "db29fb86237f21b132eca6d30d8fafefac6fe6811cd8f571fb2d59313d71cfd1fdd353e10beb4d0d"
        "4833c2fb70ab8b853067eba5fbcd6d86457e3d6d80a3ba56334f8bccb76a4403bf4072452e756032"
        "609a1b2d30fcc111cc7f5ce430d496971e3f4cd2c897a884d62ee0b82dc5c7c70e17f5058b0539ce"
        "e532b892f655b2e1738b79e1d53539a7a5813fd47ffdac5ed4804e31160f1a55ec3a5c3c7be4cd80"
        "3d24ac9b47eaa96a49db43896cf4588b92c4f1a87b5337a619b5125ff672c917374deb79be16a986"
        "616e53828e55afc247e98a4939781f49b0ae26ad65d2a352cfd403d4f92baedb5106f0e75fbd10aa"
        "26e699436e8cd90f0ecf08697c5f5e76fd167e24aa613172bf2577dbc26eb04df344d7e9da1293cb"
        "54918ceea3ec1b07a0cc6d289306eb5487b15c7b6d4adbe098852fc61a28c7f2e679325b0121cdb1"
        "d79a34a1ea16d5778156fa705d7138e421ae8bac23c7bab7a859c1ef298313cdf383e8598359b862"
        "d073a738ff24d7d9b11a89c05ea963e3ca4e7dafea372d2dacdf08762a75b24f235a6f3b1ca2a48b"
        "80c534548479d24401d783133ff08e0471598e9c0f328e600e1b5ea7ec49e59817a73983692daf9c"
        "113e0d227ca466fb50cd939b1562f1379fa9e63f31d69013db2253ad33aa116b6246c3f214ea1a54"
        "22b5930bbf7e97ec329cad9f1a85ba251377064e2ec67a51655041b687f54a789521b955825a86fb"
        "24092eaec59af9c82df6e574f4a22f4606e391fe25cebac26f2e7e30bc6f335e873226d54c6058e0"
        "48fee32b365e426a713778d862c6a2efa2803685227ea770f07f2329fa4093db9e61934054a5e317"
        "860db3824bbffe49a0e4d00a6d37fce3f0aad3615b6734e2903175f0dc22cae8dbe0c197e41f1557"
        "06f3a907773ef296fe229892d135544d5e51d529f3c6ae2cd83bf154edf64f02041162a44269d9a1"
        "3bd5ec48d15fcdcd753d51f22326fb11301c85cdf878e40560acb2895875e2e7f65a5f91348a7810"
        "f9bd2ea88d3fddfd81e13ac110280711a21e30ccfa30fe04154ddcafd37208c444e37777536feadd"
        "73ad29738aa966cb951709f54ed23069189c8ad0cddce62b3aa391106b69d903d8f265bb5d4edbd9"
        "e5369b095500835e150e3403f93770d336f51fdd8fe416dd47df4140a113442e00eacc4e358cb81e"
        "9218cc845edbc55733a6ddb0b9adfa548ba7afea7c15d4ca0655d27a5bd6fff551637205b9266a2b"
        "f19ee83533454d28714e8edcb029ec99997219257e842c69aeaaf64ca646ba24c63c26fe302afca9"
        "69693a59d386e1ebeb2e615656b25323d93a2cb19eb8556285ab9bb03a4b6ba1f673557c5136b825"
        "cdfba2284eaa45e98deae6409ebf2c45de789b5ae57e641fc4d8396957cfa7e3138d1411ad6f55c3"
        "c0167922ec3f6e818b3ad0d1b5d2d13322a081acec6eb35b8c139afefb107d9114742be5386b51d4"
        "4e23b2aa3b7be16d8c86d38275fc446c9728749e3e098bfa9f7d6736d335a91f19dff1939b11aead"
        "33fbebde5e156920fb306e22c326b1ee1b57fbed95ea2331bef89d0ac8323ffb8ea31fbe5d0cd0df"
        "927eee2edc542c3eb0c31f5e118fc15f0efcd5f374332581715a122e39bdb2c449362cb8ced575bf"
        "b33e56cf1a3d134ef30dbf83f98a7db2f9ede22d332d86fdf2bee607f74eb64e6dbc523ea97bf011"
        "a1a13c453d85ba8e5d112311d84dfc68332d7e39209d78c7e445b11b8b9cc44dcf593f0bc7c87d6b"
        "2874ff5dd0987edde288721f809724240f5af5b9d17ba0f44d7d30628704881695591b74f1eeb04e"
        "ec3eaec8073b7198bfec6daa108c8e6489155cd084ee6e887296e3a059736327723c587fb4d6dce2"
        "25fbd335ff9eb29989f4732168d8f4d25febeebc881b5aa4aca3678766f521b9dc406978aa8e3937"
        "e58b9bb7d4ca7199e2db1e2d10b12a29600ce893ac4fe827399f30ca48a3d1d5270e619cdbf03d09"
        "dd586a66fc464027084eabda5772c964187dbc3de51c8ecb60b67bb13152871257654650c591e5a5"
        "d4afe868084074bee3846184342954ed94f4ac182439443983cc8eb988bd546dcea1a0ecd6505497"
        "e46111f781c22d8cb4c97c15af8442280a45728b970382e2e966a57fd25036ea6755363180e1248d"
        "a525527c32fa279833b0bb66efe6a54a14de85392ed05e61a2d1142319820c86b16446ef6a0706a7"
        "9362eb2c742c5bde2c7cf618d5ff64695e4db1fa9af6c635ce96bc110e74e16311afabdc37796cc1"
        "e1644f7d352383dafb856b46328cd9dfb06db5198b59de55dafef54719ff0398c76dddefcbd93f79"
        "cf6e963cd79daf2986b3a847f7b183d58236664606bf280615def64953ff18c147bf662cd53be5ad"
        "50b4e232f2185e2220f3857ab80220290e65f05ece4c9be7ddf5ed4aa046f13c1c014fd0a4f1e54f"
        "92bdb0898514858eeb347b1acb3faa9e5a0554d2514ca3907c2ef1c7c7182fb4f5ac5a768f238e29"
        "3d95a23165dbd381e99dd1003a05e98c26faa010abace4346a006da1a0ae83487b6f14d99f396b23"
        "0690b2d77d1dddc5acd86e675dc551852966f1eeb9cdf07e4509e359791650239fbdff2836b49b0d"),
    "align_mono": (
        "d2b6c6bcfdc64e72ab30c668b6add90a5338d66f5fe398bc13a3dbc1b04a60d97cd451a3afd93191"
        "67c6bbaed93a776b608f10b56b01a64dce70d1822809392122f28a9dd500db58ca92c79a9d8aa1c3"
        "7f11f743b7f7b19381721d00738f9fe6a9c95ec7ad900d1b34b365439713307a84d7ee4c2f73cbe1"
        "8216f145e4bbc95e323f0f3e3c097782e80d928dc8d832cc4bdf2dd7bd2c91f092a92480ae260b81"
        "b50b788768e08e6ac2ff9a5c240c75f378576733eddcf4d2aaf56f2f08be0390e822abc982225cef"
        "24e1d4042dbff62c07de9b8e73edecaca97fe1d5a6cc1ec82a9f66b3c4d421dadf3b6c5879bb3b07"
        "76975f839ce4e5a5f0afe5bcb9944ba9f3d13c91ce2f3a0a70fb8a5f5040902c61982d8f6817ba7c"
        "b9103fadc000d798416a8ae93b738ef83a35164e27b1227306aaee8fef24f15e43c16d050dae1e0b"
        "7c7d69096ea69da72f6e0e7c7e695eea5a74e9f568641bbc69dadf76282368caea2d4563898c26b4"
        "53e7f87daf1fbe8e386824aee7107d60218e6b1a55122f18753496d1d57b5ea387190fea9273fca8"
        "c597eed3107416c8b847a32729dec4cc46d81afdd67745f5dd9414d71b899f312523a0946b23382a"
        "3a39624063cdfb4df0a6e01ae542c3557b856090d4c22802999c8c6f836bc000e5c93434db938cda"
        "7ceb5b94df4576edfadd299924f8f17432eb93b5ddeb599ec52b80779a9444a1fbd855ba42e78a22"
        "b4da9e99f854a9878a608787a4971f6e1c511c523f8c0b2616719c356bd48f27c1d0fd5e6a336e04"
        "9c970c496291e81e0118700a809916a7e76eb6bb1d61b6b395b2ec01d34cc56ede984bcf95a96208"
        "382231449687553031a32c2de83f7e269d5c68339d6ece5f6aeeb63f4accf19159a115afa8d79881"
        "903706015798036b9853984a447dc1d4c3bd81711fee28f0e6998d23f7e88c1f4cc7a13dbe8f95af"
        "88a94eec2f84c8b17032a8978cd034d0b9c3e2a0a20ae0f2a780f21082969623846ec4c4675d8b62"
        "078f741e71ff1a0e02dc3f9a05d95f84ec0abf97d97fe30c5667d2ff157b28c8940002a33dfa19f8"
        "116323870589629c671031875c5c272917e4f57d9461fa293d6554f08f89bb2d50f6c22f86f243c6"
        "b50abf70d0986042249c3241e5b8f6c275c8bc1ffaf99e64d393bc5c3fceef4e974ef525808f4d2d"
        "511c03da36340cf6e2bb66c708adab5433ecedac26aa8e183a08704bd1bb609ce4d969bddafa88d4"
        "d52b8e76132bbdedcd786928241786c93df08e907ad9d68857b37052f60c94021b92b43dfeea6859"
        "91212d8e83f0339a6ba91f0d9d913a1fe39b7af5257352352d21a1044fc62627b564743d70668760"
        "2ccf6709787bfc26082e6d3695a60a6876ef7ac544591fad49b025920ceb23e53f9578fd0e58835e"
        "3692b5b11e6635e01b900c7fc7bfa7d16c28e7bd898d848916598485549d7104cadbc88d67e958d0"
        "95631d96273c28106da9001f7201bf7736916a8be66d9f69a97bcf94848025f4490a37444fd15c55"
        "b5f983bb21e7766e5c34725ba121179da5f3b1c57c8e3c00301360d7ce87091ff6b32fa497266936"
        "e40110eb6e273a7eaf0ce16fbc4dd6fa231675c6b4b0c8895fa43f71c570d314721d8c7711f33774"
        "c2679a9ae0a4c096cda45e212156068d0fb8d44397393588f4511bd6a266a60f2276cc5cd44d535c"
        "4ece61152c61c15c2f9ff26fe740e59c29fc3be9dce0cfcf43d8a239559d9ee6628e0663de13afcb"
        "aa3c9d47124a63f7d4a21604676a1600803fa10da0b4b484f168afc854b90d0568fd47180ab653c5"
        "51f8404c1a69447960707b9a03800c4c3ebfcaa777aec9345dd5a4951de191c836d50153c2762800"
        "c1f9abd23c17b24ee0918780cffcc3e40465cdc707eabad3d7c3fe9ad065a5ad966ac4c3f9dc450e"
        "819772a600a9d760cb04dd81c564d259c09d01288696ca03cc2244238329c2a7cacdeeb6ecb8ed2a"
        "2cc1437b9ee86fe19ff6b1a7a596672a76518527f5ed5842c441f1e863a3c5f629130bca471507f3"
        "8e833eab6f51fc0b244337c98040bb866d9c0f57e4a5bdb056406add6060b326d00f73d61d25a523"
        "dabb453969add3fd8063a1313c5e17fc61152e72360fca78b9a81ec6613ade3143685f824e0249a6"
        "f9de484e8c7511897bd425c6f0a192bce3f539db99f63055eee75b6be5c9d7e560920d22721598dd"
        "a548c84f2a7c9bafa7c47f515109bc8433d936e50bd564e8d0ce7304723c0d580430d9271e453696"
        "2e4296825debf2fde4aec415a0c3222c8e3ddfc58398ee9b3755b359848ae5dfd806b21c5865e325"
        "202e0a73ee29d40fe7cbd8da0fdb6bee323e8413aac033c2e2f77379cd8a2a59d17a6653fbc1aed5"
        "c582a9481a8f2a3944d01d09bc29dddfb7f640bf52b8af2f1b9f41e0728eed3395dd3e482e05a841"
        "d3793656b38d5b81ef58e8c3597792c619f26db6f5d34cfa0b7f9e2d97ab3b562a07d21ef886e95c"
        "ccf996a5da443b3bd8dcad61d6beab90b18418f48df111a5635354958b04d40a078a69b065b7f6f8"
        "620824754161e944605ed69f451b41abe4c620cc1226475e6346f7323998b147a0857a6a045b900b"
        "55d4978d78bf685b895e820dbad609e346de6e09f1b354c20597463e6952bb68063b3c3f9a412c8c"
        "88103dd6e1795c583796e1078762d795a4ad85b2c690a5966405036350239e024ad231f34cbf4570"
        "0edc1a9294aadb60bb17df63269c310149b37b63cd30163deb3b2335c74190a84fc71910e59ddfad"
        "02acd066629d82293a94302977858ea3c3bedfa6e624ce56cc282c3e7effe4f78fd0ba365d9ad393"
        "3763b8231f69974038d854383ecf683226171876460f943de0860afec25b7e66f6446d31ffaa50bb"
        "ff028063fbea1a6b5a69b7c96252bd758daf47774167f606fa1853d45658fcbfa163814b32274da9"
        "a59807058b3ab37dff4e78547782802149f738bfcf79e915ce771356221c81b0fcf5f8894c8ab16d"
        "bca449aff92302933fef799aa332665c30cfad5298a240e0b3c8019d626d057f024c5403c17b8611"
        "7993efe1fc4e4aeeb93563d3012718657464d0143370c652d4052020cc51f2c02d2449737f493d25"
        "a30a873a6cb3880166b1703170fdaa3e6eb07550c328eff97bb0e16fb8c801f172481e5d6f259df2"
        "97a95217bcafbed8f11cb5437a0082de55f94c9f2423f566cb1de3e3fe040481aec7c95204d1a937"
        "a63780a17d9e3e6c12ee0d98981cb5371e1365ffaa0939291db8f7d9a36984b159e4d37efb4bd197"
        "68cf67f6d3ad0c8779008186ef1c2836741a22a2ac54ee6fb3a554b11936effe4d40e86fb79248b4"
        "1c8e3372a20c00f74a23603068de4700b8b0fda07edd8c760fdf38d648cb5f657e5698a089c72521"),
    "align_equal": (
        "75f208a303afde8d55c635357e48dce6f6e80af6276baa925cb0caa93159d4caf14be4ae6f5a913b"
        "2733c26b5b5ebec34f0c6be6e0ca265a29f2dd45dd099cf51780a720b6e3e863cddd5a108e374829"
        "12d4829b9c43da9917e08f2540b7b32544efb12d8f92ab055184ffb6143a4b2d3e28cc65cda320ac"
        "e3d74b1a7f31f36047d0ad7fd003860c1d7e0258eeecf063e80b59d4feb7baba0cb2c2640ed14162"
        "bfa1b7fcbbfc64f45c699c4cd9538f3d70e791134a00af27ebe8b131e2712e82816fb45a21aea538"
        "feb5aa84ee20df70e38315022792c674e94779ed116f5c724616369db21505f6cee7bb8b7fc2ad92"
        "e05e611296e5db91b502fd696ff02b4a2fc94d7cd4f19ed2b9f47e2ab828f54519598efd0cb037ab"
        "ac447c4052fcecc463fcc6207337fe3f14af482f61031db086f61582deb4a7153e3d8afc56673793"
        "60aaa1276e4e6c057dacd04ba484402e498370dce2c2cda5a915e6a5b9bbfa28cc63c91b8b4ce378"
        "6f498691f781b21cd314743eedcaa322e81eb0c09a61f6ba8c5b9b0bf41db51aaaa92c7d50f945ee"
        "9f7f6baef55aefdb897545adfe4920ed25a26b3a2d51e56fd61f0bd08b6717c482e4b1ad0fc3cb8d"
        "8723f8ec5e7abec170bc13fc5f04d8fec4402d45b3b3bde65595dea644d79db39347836a427e9dee"
        "73164fc545e38226109e00100af101c42469aaf1e9d8cdd47bec1bd833f4348dca488f8c14296f5c"
        "1e91a5b3083288a24d4135d9de1f14cd09233a660abf8a923393ba1544c3350e4a9004fbd0caba70"
        "c49b87728893a032eb99918cb1e7925e45f9f0048566035cd22954a9890f033a95655e631682b70d"
        "3c7c3795d09b15fa86a4308b3d377ce499062d5fc6a83aef0d8e48d958ae3e240fd38a40771ef09e"
        "4a7682a2e7528c84fd660743cbaaf734b56b60c948021891e4b079bc197e62b42144d173420892e1"
        "f88333e77c1256ffdce592dbf85253cc927e1cc92baed2a420cdb32a79d8e3c92997ad9422683663"
        "97dbbbfe9139d4c17fd7838dd60a37f535845d7d593a81f722b0918272cf1441a4fce4fe04b5bf4d"
        "06a7a55f073fa2e5b4371332cd58f78b0170c359aad5a67217fe8555fd51b752b7050439318f9873"
        "f17584942cf65e3837bb9f904419825765260c36fcf6274a29b9d27c0c182a36649ab33181807a94"
        "c2d42f2fd34c8b3572e1ed75338ec2e9d09aeb16148df442505591e4ed20444ec2ae7fa8615eff1f"
        "30692a07988fcd786a95c89307dee59746572022dd118df60118cdbfecbb9426a79e6bd120ea7dfd"
        "7610562b4a991caef64d7735c51c1617b2f711934204e9dcc07e8a1b9765278c769057db3232ed53"
        "ed230150dd392d83cc16a190efaf8e8bba67fcbb316ab9e77b10c22154e155425638a1506a1e6dd3"
        "801d5a2f28e91b80b49f67c60f05dcfa1eb2ac3d4dc655791daf01652694690787de405373ffc21b"
        "80ee40b572368ac95da77aa29774e306da1ed5fd104b50f247896dcdef8bed099b97ed8b37cec1ff"
        "52357cbee8c65ab7b2f2d94d7c3fcafa6881bf8130ef361723cda4d1c5b7704e26710f90834c08f4"
        "d24c1dd20d83f89a9d34ab1c1aa7e768363cae274d608609df51c277e774a2b9015e1eb798988a16"
        "70d1737e2fbe6fa18bfd063a3e236f4d92cc79d59c8382f12c0c49c6925dedac5bdc9dbd1ab06818"
        "7e886d3d14e8354e9ee020fc3a462c3ca3ac4523b21336924cb73d7dd8abc819717c4d07d5628bb8"
        "23cdf3544b31d827ba6466a59e8e4c8823fc455147dc4ff4e3d8730b7c3183f879dbfc219b1c571c"
        "42c6571d3b82ebe18698369f02fc2f9110ef7c5c83aa8b3948a36d7e0d47cdb220573e63e471fde0"
        "5e90686af2ee97edf39a6316ea06ddb62bb8395e3d28dd3156291bbed816e3b329d273546fe9bbc5"
        "381e900d106f70e9ea37c8904e70b09fed9ccb63666f885698b6b938a2a269aea8f8cce24c4b8028"
        "d34b4d539bd0a671abba6f3f7332ea566d28bbfdc1bdeabd562b1678c6c7ab3d0fb456609331a065"
        "3a045fb7c17673ea0001a2b2c264d0c3fceb90c49f2fe2f2652bd3e01f36dea50ff36a25b9a2f6db"
        "0eebf9752aa2e1a29d0e8ea2cc5ab665158b6356006ec3399c7dcb9dbeda44e8d20b1f6ef2962c69"
        "08e7437c68b79dabeca20e527754e74961a3ee864edee6ca7d8977af153ddf1a1e05fa933f682b6d"
        "2f8894b6da0b4a921a747bfdbd477e28091eb2284d97f1daaed83c0d378728a9be6d7d119d7fe6ef"
        "6edf914c75d253a8b9b1e6c33fd113fe1e434a294d99f6e2fb5a1524157679eab177fc508696d062"
        "3dc8ad360185d4e6f42b20737ef6269c7f63cd0de6b85c2282bbacff09e7362fd99310fd3a46ec79"
        "d1fd3a40a83dc65263b72b4c8b292db5d1d6bb65739e01f36fd7c15e3fe88cd0523d6665be2fb8b8"
        "1949f747c588a550cadf8d6b2b2c33a6b87d010b2edb5bab9ec4b0150dd4506c8da82dec5befab2a"
        "e5f28b23767778df1011b7268d519f52a5fdca557e7d1ca23da30e80e1dbd72877736a507137eb54"
        "ffb812f99b94c7acc26a48dc8c001f82018099680985b78003b6178ff38565b4012911b8367d58d8"
        "8a02ab191ebb0067457d5511d22384ad18a4f3940f577917f91a0e6d3d260a3deff78eaa557f0e34"
        "48814c240781c4b46d11ca6fa8006b494c92fa17ae45630fc08f0b61f932b5ac943fa53fde099d8f"
        "0893a743c02530f61c2bab1983ebe6f0d0311bcacf11d19847e723a8162a3a8528cf826d7e0b0a07"
        "55501158bfeb12467a97e1e6489d216d0e5ee24361c622b3f57fe6a7d2077806e399e0d4e92fea60"
        "f302a2f20131a50de39846f584b0283f3bfeebe9fea12eb6de00826b72121a2669a779b8872bf639"
        "b4843d919573110d51eb6bf1e70370b5a48a470470107b71b89a6b16fb02eba3c628491a412a0b5f"
        "997be5dcecd6162a63f8bfc0f36e7085c7a53cc4d58bf3c0660d5b5ebf5744db61b29e16ff5ba233"
        "17fe70047d6b8c6cdf6e105ab075071dcbc177ff9cb4dea5d5b5c45826b0b989fe73d197baa744a4"
        "4c9bd7940088ea98924251169a997034aaf68257394a6ea3b0b48df238348de162a84bf14f2c8e02"
        "fa92caa643b856f75d167de371decef214467ea18c3d848ddc02dc0f8683a6b6032d3dfcb2faa1d8"
        "73fdcc46c595e0095bfa5c848050b9230e35521a58672c285dd3aae92591c14f0ac550e344515c3e"
        "0516129d036e4db9f315b9695e2cb53d2d89ee5d021fd8e15177733dcc52ae0003866e2856dda671"
        "724ba683e4544fb4a08043b7c53d7e60679cf90086d4199e6b78589fe612ed01a6c4a51bf61327a0"
        "32f2484507a7984006d6677c451bcd4dcad058d90ec2f06599bcf00688b5728d180116f4424807f8"),
}
# GMM training on the card is held to the port's run on the CPU: like/frame
# within TRAIN_LIKE_TOL nats at every iteration.  Flat-start EM parts on
# float order: the port on the CPU fed the JAX package's features (up to
# 3.9e-3 from its own) parts from its own record by up to 0.111 nats a frame
# in minilib mono (0.015 at the end, and one Gaussian fewer); the allowance
# is three times that.  Whether the card computes an EM step as the CPU
# does is held exactly by train_step.  Mono's Gaussian counts equal at every
# iteration, tri's final count within TRI_GAUSS_REL (a leaf that differs
# moves the removal of Gaussians under 10 counts)
TRAIN_LIKE_TOL = 0.35
TRI_GAUSS_REL = 0.01
# one EM step from the same inputs on the card and the CPU: float64 sums in
# another order (index_add_'s atomics), the M-step's E[x²] − mean² losing
# up to two digits: the statistics, the like and the new parameters within
# 1e-9 of the largest of each
STEP_TOL = 1e-9
# neural training (minilib stages 5, 7, 8 and 11): 4 CE epochs and 10 chain
# epochs (MinilibOptions' 20, cut for time: the objective is flat from
# epoch 10, PERF.md §4), each with a finite objective (CE falling); the
# trained models decode the clean held-out set at WER <= MAX_WER_PERCENT
CE_EPOCHS, CHAIN_EPOCHS = 4, 10
# one neural train step from the same inputs on the card and the CPU (fp32
# in both, products without TF32): losses within NNET_STEP_TOL relative (a
# chain loss or objective, num − den over the frames, within it of the
# larger term per frame), the parameters after the card's optimizer takes
# the CPU's gradients within it absolute; the card's gradients no further
# from the CPU's float64 gradients than the CPU's float32 ones
NNET_STEP_TOL = 1e-4
# iVector training (minilib stage 9) on the card's features: the UBM's
# average loglike within IVEC_UBM_TOL nats of the port's CPU run at every
# iteration, the extractor's mean |w|² within IVEC_W2_REL relative; one UBM
# EM step and one extractor EM step from the same inputs on the card and the
# CPU within STEP_TOL (float64, sums in another order); the online iVectors
# of a kind-1 (full-covariance) extractor, card vs CPU, within IVEC_ONLINE_TOL
IVEC_UBM_TOL, IVEC_W2_REL, IVEC_ONLINE_TOL = 0.01, 0.05, 1e-4
# the port's stage 9 on the CPU (the training set's CPU features): per
# iteration, the UBM's average loglike and the extractor's mean |w|², from
# minilib.train_ivector_system(None, minilib.compute_feats(
# minilib.training_set(MinilibOptions())[0], device="cpu"), device="cpu",
# history=h)
IVEC_TRAIN_CPU_RECORD = {
    "ubm": [-129.35153138635258, -123.31051731018962, -120.49180412966719,
            -119.0183402049245, -118.33832334290962, -117.84610659950661],
    "extractor": [0.06803470193478653, 0.47706195973572874, 0.6013541746593194,
                  0.6799989040479931]}
# combination: the card's search at its full length (60 CE / 40 chain Adam
# steps); card vs CPU on the first COMBINE_CPU_STEPS steps from the same
# inputs (the CPU's 60 CE steps over 64 utterances would take minutes),
# weights within COMBINE_WEIGHT_TOL; compute_prob and compute_chain_prob
# card vs CPU within NNET_STEP_TOL relative
COMBINE_CPU_STEPS, COMBINE_WEIGHT_TOL = 3, 1e-3
# the port's CPU runs: per iteration, the Gaussians before the update and
# the like/frame of the statistics, and the final count; tri also the
# largest mixture and its tree's leaves (leaf_digests):
# tests/test_torch_train_recipes.py::test_yesno_config_1_at_its_defaults_on_the_cpu,
# ::test_minilib_stage_3_on_the_cpu, ::test_minilib_stage_4_on_the_cpu
YESNO_CPU_RECORD = {
    "gaussians": [
        20, 25, 30, 35, 40, 45, 50, 55, 60, 65, 70, 75, 80, 85, 90, 95, 100, 105, 110,
        115],
    "gaussians_final": 120,
    "like_per_frame": [
        -125.2726425064064, -108.95874306768079, -100.22972579257663,
        -94.64486053905189, -89.87872531824684, -86.29366407232654, -83.6913255473734,
        -82.63501886756785, -81.52483032389756, -80.50402391375728, -79.29281390154758,
        -78.58717905347534, -78.14988026118174, -77.56211359581849, -76.9262030340627,
        -76.36958885880112, -75.81849303567434, -75.30019121937725, -75.02060012827944,
        -74.83927222616829],
}
MONO_CPU_RECORD = {
    "gaussians": [
        125, 143, 161, 179, 197, 215, 233, 251, 269, 287, 305, 323, 341, 359, 377, 395,
        413, 431, 449, 467, 485, 485, 485, 485, 485],
    "gaussians_final": 485,
    "like_per_frame": [
        -137.86565699621244, -133.23243689221542, -122.46004551812473,
        -114.20264545874362, -111.63793436252072, -110.01633266666569,
        -108.79751901436659, -108.13266141723928, -107.59529653911139,
        -107.0530243694233, -106.53930817492426, -106.07218395076058,
        -105.6001380211171, -105.23630555528062, -104.84721846857434,
        -104.49780537832856, -104.19904036287082, -103.94389468655476,
        -103.71964046343726, -103.48561895617165, -103.2332605288495,
        -103.02645560514617, -102.8524109162841, -102.68551421961917,
        -102.5959923303624],
    "largest_mixture": 38,
}
TRI_CPU_RECORD = {
    "gaussians": [
        2000, 2100, 2200, 2300, 2400, 2500, 2600, 2700],
    "gaussians_final": 2800,
    "like_per_frame": [
        -97.90422758201223, -97.20976408358885, -96.73137105623762, -96.15602546814367,
        -95.31119820394531, -94.71507697014924, -94.16210537544917, -93.70010946530162],
    "largest_mixture": 52,
    "leaf_digests": (
        "000f14a20023d0760070e812007d5ef10087bee3008caebe00acc86a00d2246500e790dd00fe6666"
        "010dac39012029210135ed5401413767017f6c4701fa87b102174bae021fd0c502330d0602841e02"
        "02c7d94f02e8d5dc0311cba60357133c036b836303893d9403a3a98703d4fbbb040ec3460413252d"
        "043a8f0e043df9e5045457e704676b69046efacf047bacc8048cce5a04bfc6fa04d5f65204d81419"
        "0503d82b05357c83054dee170552f815055ac4650573de62058c5df005a74fb205ad4cd905bc6123"
        "05c9fa2005ecc1820601dc5a066bd7630678d26a068a346906a6263a06e58ce506f21af607279625"
        "073cdfb40746523f0751485b0783a68807b60a2107bb79e807dfd38c07fe52a8085d907808611adf"
        "08863795089f061b08dc279808e1b3f9093efa15098bdb60099458950999ba91099b6184099ce9e6"
        "09a868c209bb718109d0df9709e0609309e41b8709f2ee460a1e58c40a2b3c840a4b3ff80a68b61a"
        "0a8402530ab241550b2ac7560b813f1e0b8157c80b90c60f0b927d820baca5590c19619d0c381f7f"
        "0c691e7e0c7393720c86355d0c9970dc0c9b2eb40d0f87f40d3a04a20d56e91b0d7453440d83d652"
        "0d9d70570dae74f90dd0fecf0e6eab6d0e6ee18d0e75a2230e81a78b0e9f91390ea162c30eb70b77"
        "0ed72b470f3c462c0f60cdd60f6eceb90f7074620f9727530f9801ce0fc05ddd0ff1bab11041c4f0"
        "1046b23e105c039f106b2a4f108645231095c5de10abc4ff10ac4f1c10b2658010c2117b10e79c5e"
        "11063357112f6f611185741a120c68cf122f796312342262127ecc1612b0328813031c99130cffdb"
        "131fb0ef1346e451134926fe136a9637137f96a7140054a1140870e2142fb8de14b42b8714e5f703"
        "14f8033b158237af1598664b15b48db515e2ab7b164b5902165b98f8169112e41693a8c016a8da92"
        "16af5d8716bbb10b16d64d5116fb8608170b42eb1724ce2a173a8059175d9f8017943320179d83c2"
        "17b5cdd11803e69d1803f9101816833b1836b46a186aa88218725a4c1884c59a188a86f1189948fa"
        "18d72e5018ecaaaf193867d81944c52c19862c3d19bcbb1119d220731a3f410e1a43bace1a489007"
        "1ae8e9d61b05e2481b07b1291b0a9c011b1cee261b480d0e1b48c0f21b902ec91b9306cc1b99893f"
        "1ba755721bb9657d1bd2c7fe1c2f218e1c4a7a8c1c734ed41ca5065d1cf30a961d1046771d2f4547"
        "1d6440701dde81ce1de057c31dff5d151e313a351e4162291e4f43cd1e685ab71e803a8d1f3399f5"
        "1f57dc281f9e99501fa3e87f1faac0861fb20ee71fd76c582019bf7a201d74a9203e852b204eade7"
        "205edcfc20654c6d208db93f20a5981420b8b13a20d8fdf520df929d20fc022f20ffd5d5210378e8"
        "210ea5fd211d0c8c21409f8b21a610d821d313342240be3a2242093922429b9b226f44162278e2f9"
        "22af715b22c0891522d6d1892307c69f2312edd12340f4ea2377924523bedfaa23e9240d24147c23"
        "244ef84824b5c92424b859dd24d7161624e6731324ee9f7124f277eb250764ea250d70f525234dff"
        "25724362258bf7b525c0be7625d95a6c262773d426542eaf266aff612699caac26da1828270f9113"
        "272f93cc27394bcb273eb8ba2758b8c3275e3e8d276c0ef027ad1fde27b2c80027c4a7eb27ca5154"
        "27f2c14c2804dbf22817c3fa28186573282fe3dc285c1e5f28722d7f28d8811128f350912937de64"
        "29397b5f2968bf9e298f80e02994ee2029a8748329b6496229cbed0029f977de2a08ed722a1326b4"
        "2a3471d32a36993c2a5c5f0b2a789af72ac7ae3a2acd036b2b07f5fe2b3f97742b419ebd2b9166ef"
        "2c04b8792c674b802c7984412cfed6332d2812cd2d2f766d2d3c3dff2d7bdf432d7fa0a92d9b2b53"
        "2da7e2962dadbb8b2e0e12712e0ee81c2e48fcc62e5a8f7e2e5ecf022eba991a2ebe8e122ec8e915"
        "2f464de22f4a09592f53582e2f6fbacc2fa410062fa7a7cc2fbba4202fc7236e2fc8123f2ff49caa"
        "301c845d3041e8b23083dd8e309c6f6330c986c130ec79e130ff87403111c6293119609a3137c117"
        "315912df319e62cb31ab81e031ad9a4431c5ffbd320a05253252c4ee325ac2353284603132996c30"
        "329a1811329b369b32bd6b0b330f325a3358e97b33ead30f344fb2ee3454252e346c8e90349a865d"
        "34b063bb34d2503f352a70853576a79b35c6a35e35cf0a4635db6c2636165e1236560450366f5d06"
        "366fa03f3689ddcf36cc1384372ad01437312afc3774fa4e37767bc43781b55837a60a7f37a8bec6"
        "37accb7a3801232a381bb8b9385da6d038ef892d3907dbf53923ff2c395cc76a398f043f39d87ae6"
        "39dcaa4d3a254b643a9cef753ad583363ad755763ae8b26a3aef8b973af3e5a23b236a193b2d456a"
        "3b54e8c63b8b373b3bcd55d03bd6a06a3bd9f2663bdb158f3bdc768e3bed3c1c3c1b7be43c3e0c3e"
        "3c7e9cb13c880ded3c8b791e3cc017f93cd546653cea2cbc3d5d83ea3d69ef633d721d773d879505"
        "3d8cb0963d936cfb3d9ccd8a3dac4d063dcdad383dd21ee43de2d9af3de6e33d3e0b38ae3e19d071"
        "3e254d953e2c375d3e3027343e40b3ac3eb4a7e73eb636223ebd8da93ec3bf9b3edc2dcc3eeaa190"
        "3ef0b9683f09520e3f0b1b833f0e66403f2d77dc3f2f7f983f6155fb3f8c3d6b40194b314032bc25"
        "40394b00403b5cfe404a83c2405751f640774d2d4095a9144097adc740cbf81840e3655640e4bc26"
        "410a58f3410fe0c941334024417d92cb41ab14cc41cbb08841f8880342107c97428e51f842913c5c"
        "42a3fdf842a8e2284363db2c4369d29e437b2b15438f3c934395b3ae43f3f8be4406232e443bb28e"
        "44459020445d6bfe4468b3ce446e27c744e0f60c44e972bd44fa0c6d4518fe624536f6774543a2ac"
        "455227ce455ba4d645d0408145decbd545f4d6fe4628b646465ebde446a97f4646c7530146e5acdf"
        "4703261b47093608470ed7c447261d63476781914776adb24779347a477d66d947cb915247f7250f"
        "4802e56f481cea6848337a714834e16e483744f448516fbd4854e7be487c76df48dcb9fc490db391"
        "498a519f498e7a7a49a9d50f49b4b08b49b4e10849d574974a2c6d3a4a3066ed4a7439114a76cf1b"
        "4a8efa9a4aa3fdf74ab42eca4adc45734af345254b27254f4b6202684b77eb3e4b7d0cfc4ba95e84"
        "4bcd12d34c4d89604c4f3c694c65abd84c7be5e74c82f8944ca785054cb42d964cd00d954ce5adf7"
        "4d33ec524d4667b14d6060644d7a03ac4d8c74ec4d93858e4db90db44dc1471c4dc171284dcd8e0f"
        "4dfe6b524e1c91b64e2650fe4e32b3724e3a38134e8ee5a54eb5b1b64ee49eef4ee6a9f14f0e32c1"
        "4f2efec14f4408a64f8ce54b4fbf651d50057bcb5009e1be5015fd42502abfd7503056ee504fc572"
        "509855f850a90add50b04f8050c68251511cd3c75126750451368425515c2d0b515c7497515ec582"
        "51839ff6518726e251917ea75192a6f95197f88a5199bfd151b94fbb51bffd4f522fa1365244d403"
        "52464240527072eb5284109f52d3f498530173d7532bc2a5533d5c4c5384771053ed5d0053edbeff"
        "540b9bb1540e91c85434c52a544cabd5544d774f54611dce54a17ea854a4a4a454b2eb7554b9d03e"
        "54d2882b54ed837054f0b67d550c10625510d3b755157083554811665548e02c556e78ab5579bd81"
        "55a314c155c1d26455d7786d55ef92be5600002456125d40562b9d5c564e0eb3565352b15661186f"
        "56b6868a56c15e0056e9e687570d119d571c85f95722920d57393e52576b2212579217b057b8ddbf"
        "57d61b9457fc584e580bd8425827fd2f585b08dd585e910c588ba7fa58e6c6d358e9b85d5907fd9d"
        "590a75bb590c95c859147f09591ea413596c361f596e429f598b0550598f610a59eb8da85a15333d"
        "5a2289e05a35228e5a6b406b5a8c95985abba3555adef2795ae8d8155af502ab5b2480dc5b2cd462"
        "5b4199115b5f390b5b6fa09d5b936e125bfd61f95c1276c55c1ac7045c722a7a5c81f6cd5c95c4f5"
        "5cb61d2f5ccf40845cdc344e5ce5142e5ce8f9cf5cf1c1b55cfc783b5d15e6115d2139085d9d79e1"
        "5d9fe3645da50f555dfd73d35e5f672e5e83a4105ebb48fe5ee61eff5f1cc0cb5f46b7945f4bc4b5"
        "5f65a48e5f77b4f15f89c94d5f9a16835fa25cf55faa30dd5fbc866f5fdaace45ff041285ffa8932"
        "603c2d97604059c96040a9ef604d095a604fcab9608fcdea60a936ff6114d712611fbd5f612f8c1f"
        "61448fde6149a9ae61607e5561a192ac61a9206061d7847f62222700624ef03562a12eef62cb6a9e"
        "62e5844e62f903236325eec8635f70e16388bd1463b20e1563c1cb8963d8529763d8b3aa6418e83f"
        "6433e46b645a602b6463e050647e696364a7a64864becddb64bf651864c35ec964e1d30c651ee05f"
        "6533adc4657fefd365b753d865c240cc65c5e4e76605f3ee66278a27666f390e66ab615f66b67f86"
        "66fc8ab0671e86fe6729f769674e6ecb67af732267bb57f267ccddd368006e31681279a6681bef9b"
        "683356f8683884dd68478a5668b955c568cd9bfc68f7ca24690c13576942a278697b939869888e6c"
        "69d5ad5b69f20c6e6a405e176a7c94696adda4e86af937aa6affeaef6b55bd466b61d5916b6ae970"
        "6bd7063e6c1db39f6c446c6f6c5974af6c6cc6666c92c70c6d0543666d3799fa6d4b2ef96d569d77"
        "6d59c3646d7a07036dac720b6ddab20a6e0a2fd26e17157b6e1973a66e9c828e6e9e5ef96ec1c098"
        "6ec5c8a16ec645706ed0abf36ede8ce06f182d426f2575e36f3000846f463ef96f5484fd6f75dc1c"
        "6f9cdc1f6fb96b026fc3b5646fe50174700169897014e7d9703c5adc705bd18670623070708073ea"
        "709403247095ea93709740db70d1e4f570e7f5a670fdc459710564757105aa63711f51bb712cfa89"
        "712d89f571650b3a71721b05717679f07179ea6b718d9e5f719bfeb0719d49ee71d8bf76720b6114"
        "721b84b7724416fe72558820727dcdbf728eaf2d728ebd4b7290b6e972936c3b72a6893672b45500"
        "72d4a7b172f8bbd37343dcc3737e811f7392552973b6571173c607f573e60ffa7404b2517406bf38"
        "7431340e7456e05f7471b77d749542577495649d74c8e55274e6ed1174ec164574f45eed74fb7804"
        "7506edbc7546765f7561a3ab7562c3bb75667c1d75a18f9f75b3e34c75eeaadc76349df67639647a"
        "7646032f764b340c764fd0a276626cab76648b19766a2b0d766fb03b76ade3e576bb787e76c4d160"
        "76ef17f176fc517876fd12c4771ddd397787ab0777ab32e977d2f71d77dde21f77e4626578097653"
        "785e7d4c787a5d8478a4e65f78d84a1278fcdff479098d277914f21d796f1a027985aaa279d719f1"
        "79e18b2479e4203b7abf9b2b7adc9ad27adf8a897b02a7a27b0369e07b1dc5427b26d5507b35881b"
        "7b3629477b4b4e487b63a2ca7b99503c7bbeb9207bc9db437bd9389a7c0b37637c33b75b7c600912"
        "7c6080447c9f62cb7c9f7e147cafb67c7ceebafc7cef5bed7d4737457d4b5ad47daa9fe47db90b80"
        "7dc0ec937e0c25087e2c42bb7e55e7227e5754157e6d092d7e734d097e86e98f7ed54d867ee12851"
        "7eeb2c9c7ef435077f2eddda7f33238f7f5b0e597f6e4d2c7f77d2ac7f8f148a7f915b0b7fd6f5f1"
        "80dc98be80e6ef5c8143e07f8161c025818da9468194bf4f819b814081a043cf81aada5b81c3c4ff"
        "81c5e06681c614f881c6178781d5154781fa37ca82077381823f6dbc824ee01b82743d748288198a"
        "82a5c60582b9eba482e2c30c82f1ba888315bee88352307c83797c1e839b91d383f92040844a479a"
        "845ca5ba84618f468468dbfd847bf66384932670849467e28499760f84aad6ca84cee8c384d879e8"
        "84e0525785448ef5855d074285606b308568714b857099db85a72f0e85e9c88f865100d786c3ab3a"
        "86d30bac86eeb1f68722420c8748a497875e58988791f1b087929c2f87b0920587db354887ea1ed3"
        "87ec40a487eccc3187ee067b8822fe598834de99886d330f8879cfe888fbd271892b7e60898dfa43"
        "89a2085b89df50a989e14bed8a0803388a158ae38a2293588a3de08f8a4521748a4980718a847fec"
        "8a9e397e8abe29108acd0a2f8b179e1e8b2dda868b392c8e8b4260c98b5e4e918b6735b38b7f1e0d"
        "8bdd561a8c2ff7ab8c40a1588c5789388cb419498cd2314b8d0767328d140e7f8d61d08c8da17164"
        "8db762328deec6e88df392d68dfd65bc8e43900f8e566c0e8e56dd698e86b3db8e9987fd8efc0874"
        "8efef29f8f0e95b68f1037f58f20bbd98f54c3c68f5f183b8f833e488f9703a48fa077b18fb0f464"
        "90b232e090ba59e190d9074f90f03c6291034dfd910a4bc0912c391a9142b6f1917bebc5917d9dc6"
        "91cc695591d88d74925f1d07926f75d49275991792996ded92bba6ec92d951da92fd8d229303f816"
        "932c1272935b69b3938a9d1c93b27d5893c8e79c93d92a7d93fdefc6941f04ee944a0b30946c40c6"
        "9473cf589496ab0f94f87ac1950522219515e53e951a8fa695384bf495dca689960f5215961975f0"
        "9627cd669650bc2c9651c15c96abfcd096f211a996f9274d970da06a97678d579777670e979dcd80"
        "97a57d9397bac45f97cd3bca981528799830c358985fdab598b926b398bf48f599192985993aaf28"
        "999f2156999f742599a343eb99e62db299fdb57b9a09246f9a15e15f9a6e29de9ab159fb9ab215ec"
        "9ab4553e9ac7f3109b143db69b1b2d9d9b4e1fd89b7db4259b8d0a6c9b9c20c19b9d164f9ba3ce11"
        "9ba755399bf646799c17bd1c9c44bffc9c5777769c5b45649c8cd5849cce15ba9d3b81789dc2c928"
        "9dda42d49de688639dea9e649dec712a9df5e0d49e20b2039f0227fd9f133fda9f28c9599f46c134"
        "9f49e2319fa905ec9fb023069fb21891a0099eb8a012a552a05ac297a092b814a0addcb8a0e18f41"
        "a123a0c6a146607ba1526c87a156e69fa1a8113ca1b9e008a1d6a73fa1f70102a2065e19a23001a2"
        "a239a121a2cbd034a2fcc5e2a31fddfea338a87da35210c1a398fc5aa3eb3edca401865ea44088a7"
        "a4472adfa457d71ca460b9dda4bffb64a4c2ced5a4ce0c62a50deb71a524fbfda527ebe3a547c74b"
        "a5bc9613a5dc1a95a64f5fd0a68ba40ca6bff7d0a6e5c40ca6e8a444a6f7d9e9a70817e9a70b1ebb"
        "a7118980a7302f23a73b16dea73c62dfa74662a1a78016f0a783e6a2a79addf2a79b08f7a7a3e2af"
        "a7c90ef1a7d94945a7ea962aa80806c6a808aee5a826a81ca829a9f8a8568935a8740833a8afb32d"
        "a8b0f19da8d8387ea946bd5ea979613aa991b644a99a01aca9a5e499a9bd1134a9dd2fe5aa9cb187"
        "aabe8ebfaac478a9aac64984aae3382dab07c284ab1dfa6bab246e26ab2f2583ab3de9d1ab82de3a"
        "ab8a31d6ab903be1ab93234dabca45cfabdb93c8abdc8fecabddfb1fac284a49ac2c3185ac5988bd"
        "ac69a18bac6c73d7ac9f6cd6aca47c40acea2864acf23f8aacf91bf3ad2218bcad53e2adad5e0f3f"
        "ad6e454ead780146ad815b91ad91937bada50200adb40e15adbe5ea9adc04e5bae020028ae0d8508"
        "ae22edf6ae4d44d1ae83551eae8dc04eae9a3000aeb0f4ecaebb1844aebdb180aee7d115af377fa6"
        "af4fda80af77f6fcafbb117cafd68850b0511d6cb0629584b0741bb6b07ef827b0901ba7b0df9caa"
        "b0e31fddb10768a8b10b5e39b1188058b147d786b191cf4bb1b2e07fb201dd65b204e3cfb234ffcc"
        "b26ecc69b290095eb2b077d0b2ccb458b2d2254db3068a69b30de278b3427cb5b363d7d5b375ef92"
        "b377a3d6b3a13d3fb3a1c79cb3a39a7ab3ab9facb3b9e716b3bd0fc0b41ea08cb420949cb43ddcdf"
        "b493dca4b4f9cd17b50e8accb517937db5183a7ab5253589b5553885b5629234b567330cb5680fda"
        "b576844bb5ba4735b5c914e0b5ed5fecb610dd2db61555ffb61b8280b654fb6ab67ece5cb6faa38c"
        "b70fef2ab72c73e8b77ec0e5b7817c78b782f2a1b78353c2b7ab724db7b7c0d5b7f1e2c2b80830c9"
        "b8317d57b8349955b85e2c56b8ec29dfb8fa15aab91c1584b9263170b9310c9ab93cc533b968d7ee"
        "b9a9a225b9ef84c1ba04040aba1b1d79ba2203f9ba2c19efba35a6a1ba72e96fba74d14ebb10495e"
        "bb125335bb2ecfc0bb3ee21ebbb78559bbc59e11bbecf684bbee487fbc48d2eabc528967bc5a2417"
        "bc71246cbc827374bc9bb441bd08dd8dbd502963bd7f6b2bbd85b567bd955cd6bdd2c6ffbde4f68e"
        "be219ee6be34d6cebe3edbb1be751b5bbe9149e4beab55c9bec4fd34bef34ad8bf1c77f1bf663b43"
        "bf694cb2bf9a4598bfc7ef0ac008f0d8c00c8d1bc04d55b4c08189f3c0998243c0be3ad7c0cf4ac4"
        "c0f50c26c104f944c1103ce9c11f8082c1530056c2040e92c20fb121c22dd22dc242b1a9c2676ea4"
        "c2a68822c2ab708bc2fc608dc319e37dc334e845c3554389c3776083c37ddb8dc3bcc180c3cd314b"
        "c3db544cc44b8682c47609e1c495d97bc4a87ca4c4ed74b1c4f2ce21c52f51bac57dfb42c583f043"
        "c58a77cfc5a51143c5dea0fbc5f5b34dc6130fdcc620dab4c627936dc63ee9aec64a2236c64eb012"
        "c66d2a21c698e811c6b5892bc70b2b3cc75c7248c7adc495c7e551e7c7ec778cc7f15e42c80e4ec3"
        "c824d354c83ab905c84c6085c87e93ccc89623bac8a97c20c8b8e77fc8be37dcc8cc9b13c8f771d7"
        "c8fedf95c919df25c95714c5c977c741c9862f34c991955fc99e367ec9b2a3e1c9bc6a73c9c930b0"
        "c9d8fb3cc9d92397c9e64af3c9eb4b42ca4f992fca77d80fca7c6239ca85b470cadf868acaef8ea8"
        "cb20536fcb3d91d8cb549fc2cb805b1acb8f42aacbad4444cbb8ca7acbc9209ecbe0e0cccbeee3f2"
        "cc3694d7cca8e316ccaa0468ccb2342fccdbc385cce0b4d9ccea3a5bccfa0e90cd241712cd50203f"
        "cd557522cd55a65fcd6b0d71cda6caf7cdce75aacde7a28acdf97caace0a6bcfce0e1577ce20f922"
        "ce2de427ce30e585ce406375ce459341ce4c7307ce8a79d7cebd78facec0ebe1ced31f69ceeddc50"
        "cf08f61acf3c30ffcf735b03cf790661cf808244cf81d525cfa8226fcfccdd24cfe08ba5d0154c86"
        "d046ffa1d060e039d066b8afd0863fdad0876659d0917273d0a6d2e7d0d52991d10c9f64d1318879"
        "d13e018fd1509e05d19a92f1d1b881a1d1d14f7fd1ec3a7dd20d5ca5d21a76e2d2201f71d232efe2"
        "d23d2d4dd25ad189d2763ec4d2d771ded2e4858ad2f6dfffd2fd4d64d3149a6bd355abd6d36bee12"
        "d3a53812d3abdf6cd3c41842d40a4508d41dd6fad494e2dad4e96406d4f53a8ed51737afd53018bb"
        "d54208f4d5563613d6080202d63e06bed65919ead6596fbad666be7cd66abeded6a259d0d6babfa4"
        "d705809ed7169827d7232ab3d7291ad8d7458131d79d1d5dd855580cd8beae30d8e0caf9d902e34a"
        "d90eed38d93e042ed9acc2efd9bf1497d9bf5d7fda1643e1da194eecda59bc58da8ced8eda8f88f2"
        "da9758ebda97a5f9da9a6a61daa8e4d6dace817adad778c5dae0defadafc067ddb0151e0db1a3981"
        "db25d6c3db325ba9db325d37db3dadfadb709dfcdb8bb753dbdc80dfdbee6744dbf3282cdc0a36f0"
        "dc1ce58edc22ca0cdc352770dc55714edc790d53dc97e093dcbb8c09dcd7272cdce08caddce49e85"
        "dcf48258dcfb9329dd19b48fdd44b1a1dd6f9851ddf9e863deba2cbadebae636debf2ea6dec42b0e"
        "dec5ec94ded34885dee49207deede5e3df219120df318d97df70569bdf7480dddf975971dfab32a0"
        "dfacd39edfdd3867dfe67ca1dfec4631e00ef5d5e0711672e0bbb522e0cb14c1e0cef6f6e128044f"
        "e16567cae17c09e9e1a05fa0e1b10a58e1dfbd58e217c311e24d3061e2886ef4e291f9cde29b4699"
        "e29f9753e2e43d29e2ef0a94e2f2aa66e38567aae3ba53f7e3c9cf6be3e81bf1e3f48e9fe4289ec8"
        "e4517395e47a7d78e4826698e497c5d4e4ba0970e4d88a8ce55dd973e56d1995e58ac1a2e5c0810e"
        "e5d83d3be5e8fde3e61b1f29e65edd3fe67eb936e6b04239e6c92146e71ba3c7e7209a77e73b5290"
        "e746aee0e767f52ae7707bffe77e17ece786fb10e78a3bb3e7e24cb0e7e86a07e83718bde84cb44c"
        "e8527a3de8a15fe3e8a2d878e8d848f1e9112b1ee9233329e948b56ce94d7385e9670813e98798fe"
        "e98a4df9e9a5360ae9c522a8e9d96a8de9f5526eea14b55dea2529e4ea2b69ccea4427d5ea450fe0"
        "ea59c20eea5f3a0fea714edeea74fef8eac50478ead7be91eada55b5eb300b3aeb659dd5ebc68586"
        "ebd04359ebf45886ec08f9bdec23c07cec8931c0ec8d0d31ecd87f03ecdbbaffed1a489eed608422"
        "ed6bc49bed6e92d5ed991785eda24aededae439bedd4529eedd66580ede3f304ee004f3fee1c3bb2"
        "ee4a954fee59a3edee7d9957ee7e208eee7e93cdee9bc25ceeb2b208eebdd2e5eed1094feed6044e"
        "ef089a9cef2e921aef32f823ef394b94ef8b11eeefa74aa9efd977aaefefaafaf00666d1f006f2f0"
        "f06b51b0f072676af0909ae8f0a0ababf0ad772df0fa2bbbf10c6740f11c7284f148898ff191e393"
        "f1973edef19f5cbdf1ea51e1f202c51cf23ae244f2461eb2f252f7e4f26452ecf26f82aff2a634a5"
        "f2a85c36f2caf157f2e7bcadf2efe12ef3048fc3f30c3793f30d9797f3547b41f37647b7f3b9dedc"
        "f3d796bff456ea38f45d58eef472f36af47847c2f4a65403f4bf3744f4d156f7f4fce08af55f65ab"
        "f56a8ae1f5b6a255f5cd39f9f5d5b048f5dcd3e3f5dda83af601225bf622c3a8f66224bbf688ab17"
        "f6b4efa2f6ca0b17f6e8b0cdf6f48859f710624ff7268f95f7aad480f7bb6e5cf7d9de16f8153480"
        "f815f44cf8207e17f846552af84bc775f84d8887f85cf546f8d378ddf8d7c2c5f8da24e4f91b12ab"
        "f9396dfcf93efbe3f943c168f94bd49ff96f2776f982bfbdf9886595f98b8543f99e79e1f9b51ed9"
        "f9c26292f9ef0480fa02f253fa39e11dfa3dfdc0fa8f52a9faa3066dfac66bc6fad13d28faf2982f"
        "fb633b15fb710b44fb77c73dfb915557fbbbcd24fbc39915fbdf218ffbf999d2fbfa8d3cfc032868"
        "fc176b82fc35f6f1fc4eb377fc603e1cfc8902c1fc9d457afcad6949fcbfecf9fcd4ca81fd0793c9"
        "fd0fc5dbfd142719fd171574fd5099a0fd6161f8fd8693c5fd94c80cfde89eeffe0d80d1fe5ea1df"
        "fe7582a4fea6cf3ffec1aca2fed38de7fedb2e2bfef3b118ff32162fff61685effaba693ffe7e90c"),
}
# bench.py's run_toy: 1,024 utterances of 10 s of noise at 16 kHz
# BASELINE config 2 and run_all.  run_all's WER lines gated as
# tests/test_run_all.py gates them: <= 5.0 for nnet3-tdnn*, <= 2.0 for the rest
RUN_ALL_GATED = ("tri2b", "tri2b+fmllr", "nnet3-tdnn", "nnet3-tdnn-ivector", "chain",
                 "tri2b-lattice-1best", "tri2b+bigram-rescore")
# LDA+MLLT at minilib scale (recipes/triphone.train_lda_mllt from tri.mdl and
# tri_ali.pkl on the 600 training utterances' statics), held to the port's
# CPU run: the tree leaf for leaf, the Gaussian counts at every iteration,
# like/frame within LDA_MLLT_LIKE_TOL nats, the final transform within
# LDA_MLLT_TRANSFORM_REL of its largest element, rows up to sign; then the
# first LDA_MLLT_DECODE_UTTS clean held-out utterances decode at WER <=
# LDA_MLLT_MAX_WER before and after per-utterance fMLLR (tri.mdl makes 0
# errors on the 256)
LDA_MLLT_OPTS = dict(num_leaves=2000, target_dim=40, mllt_iters=(2, 4, 6))
LDA_MLLT_LIKE_TOL, LDA_MLLT_TRANSFORM_REL = 0.01, 1e-3
LDA_MLLT_DECODE_UTTS, LDA_MLLT_MAX_WER = 64, 1.0
# tests/test_torch_lda_mllt.py::test_minilib_lda_mllt_on_the_cpu (-m slow)
LDA_MLLT_CPU_RECORD = {
    "gaussians": [2000, 2100, 2200, 2290, 2380, 2461, 2542, 2614],
    "gaussians_final": 2686,
    "like_per_frame": [
        -50.59263164596295,
        -50.102617419502344,
        -49.78268777861886,
        -48.36469349121821,
        -47.951663396307964,
        -47.05139299232871,
        -46.809048614983084,
        -46.1242323296103,
    ],
    "leaf_digests": (
        "0003d8fb00198421001a52f100abf3ca00fe6666011eb61201413c33014488a0017f6c470183711e"
        "01d0099501db6a920205b3e20210a355021f8c6402456c660261adeb0274490a027a9b3902921f12"
        "02c7d94f02f50da8030a79e9032cf5c5033d92430357133c038a76f503b58d9503eaa3d80413252d"
        "043a8f0e043df9e50449272e045457e704676b69047bacc804b35c8b04d712ad04d8486704f1c08b"
        "0503d82b05334b390552f815055f7f10058c5df005c7392305e6a1720601dc5a062402f406b3fe6f"
        "06c67441071059bd0746523f075e1b280773789d077381a80783a68807afc90a07b60a2107bb79e8"
        "07c0b86a07dfd38c07fe52a808000d2d082e8537085d907808e1b3f908e99daf095b57da09761442"
        "099ce9e609bb718109d0df9709e0609309e41b870a130f130a1dabac0a3c30920a4b3ff80a68b61a"
        "0a6cffe30a7617a30a8402530aa5cbd80ab241550afb03220b04941f0b2ac7560b3b78f90b549d0b"
        "0b88f3fc0b927d820b9f07fa0baa378b0bb2d3360bbac7940bdbe9900beaae7c0c1620530c19619d"
        "0c2bb75c0c38b3f40c474fae0c566b420c7159940cdc4b100ceebbfd0d56e91b0d7778220d83d652"
        "0daf89680dd0fecf0ddb2b930e2e480d0e3c595d0e46b24b0e6eab6d0e6ee18d0e75a2230e862b0f"
        "0ea162c30eb4042e0ed001840f3e70900f4954d80f60cdd60f7074620f9727530fb244820fee1a50"
        "10043f4d1041c4f01046b23e105c039f10935fc510b0aa0e10b2658010e79c5e10f5f1b3110176ba"
        "110633571115af191121499e112ad7a9112f6f611139abae115c979c115d9b9911679b8911c381c0"
        "11e6947211f73afa123d574812537dca126c93e612ae232a12b0b4bd12f1350f13031c99130cffdb"
        "1329b93a1346e451135e599413620f50136a96371374f501138cd1a31391cd781398dbe11409c6ec"
        "140f58311476fd9314df9c1914e31cab14e5f70314eafcf214f6963815365cd9158237af1593de82"
        "15eaf4351612f5e0161f89ad16393627163ab3761645327d16504e1516616463168055c616a8da92"
        "16ab514c16af5d8716b6af0016bbb10b16c7379f16cf19c2170b42eb17322d8017fb920f1836b46a"
        "1863d6fa187ba1251884c59a18d4086e18d72e5018de0d5d18e1357618ecaaaf18f7ef54193867d8"
        "193f9f551944c52c198332c81a54da951a8b2cfb1ac560b61acf831d1acfde081af6bb401afb4a6c"
        "1b064e801b2752161b99893f1bd2c7fe1c03d6011c1d70941c1e327d1c734ed41c8791851c8a8d94"
        "1cdcbc361ced0fec1cf30a961d111e041d2f45471d7a8b001dc71af51dcbc4b11de057c31e313a35"
        "1e4f43cd1e6cb6cd1e724c1d1e7880441eb4da151f3399f51f57dc281f717cb41fb20ee7203e852b"
        "204eade7205edcfc20c39d3320cb528120df929d210378e8210ea5fd212a9324212cb68921409f8b"
        "2173f28c219dc75121a610d821a7454821b6a1fb220299962240be3a224209392270267522c08915"
        "22cf80fb22d5fe5922fa753e2383d81e23de8dba23e9240d243ecf45248dcdb6249fa48024cabded"
        "24e9d9e624f7dc01250d70f5257243622594d094259d946325b65ee525d95a6c25de952125f049ba"
        "25f5a0f62626c191264633822699caac26c2022e26da182826db4fae26e63634272f93cc273eb8ba"
        "27e14020281becb1284422f628445c8828661dbf289b888b29397b5f293ef672298f80e02998d371"
        "29a8748329cbed0029e46bf029f977de2a18a87a2a2325972a36993c2a5601042a5c5f0b2a789af7"
        "2a92b3a92aa8b75b2ab285932ac3097b2ac7ae3a2ad0d92d2b4661cc2b4998372b9166ef2bb87191"
        "2bd6154b2be63d322c0d17cb2c4b34aa2c674b802cdb06c02ce2ae702d2f766d2d3922982d3c3dff"
        "2d565eb52d7fa0a92da7e2962db0804f2dbbd5cb2dcc2f4e2dee64ea2e0168882e0e12712e0ee81c"
        "2e1c36b72e48fcc62e5a8f7e2e62cf8b2e6519ae2e8aeeaf2eba991a2ec8e9152ecdbad82ed33edd"
        "2ee372572f4a09592fa410062fc8123f300b1eac301c845d303ab73a306aa7f13083dd8e3096862f"
        "30980c503111c62931175aeb312a06a23137c117314e581a3155a0d9319e62cb31ab81e031afbbba"
        "31c09dc9322a1e77323941e3323a653132522600326e753a3279aa1f3279c021329b369b32abd0fc"
        "32cff4aa32f1d3a833097a83331e6a5a336a713c3373315d3392439033c71a6133ead30f33f3519d"
        "3415352234453733344775753454252e345f28ef34d2503f34f7171f3538ae5c35765087357cfd1b"
        "358ec5b735c76b4c35d85e1d35d95d1e3626879c362c92a33632db0b366fa03f367757e4369cd55c"
        "36b6c39536c2a0e437312afc3741d0113774fa4e3781b55837959921379a7fd837a60a7f37accb7a"
        "37c20f2137c6f948383c1d763845798138cb174838d01f7e38f5e882390bf84839278a1c39313341"
        "39319dad395ca57039632713399c314139e3be2a39e6f13f39f63dd83a139e873a22f23e3a7c0496"
        "3acf39933ad755763ae8b26a3aef8b973b20c5fc3b236a193b2b05523b3d8fcb3b51c3a13b6ec318"
        "3b7d4c003bb1fd1c3bd6c8103bdc768e3bfc7a7e3c57cc0c3c6ccf873c7dfd473c7e0f863c880ded"
        "3c9cf8833ca9f6e63cc017f93cd546653cdad4d43d12d5c03d2774d13d3708283d3e67283d69ef63"
        "3d6b9c6c3d8795053d92ae0b3d96f3823d9a60fe3dac4d063db751dd3e19d0713e2c375d3e3afa1c"
        "3e8b3b3d3ea07c4d3ebd8da93edc2dcc3f09520e3f0b1b833f0e66403f3ab47d3f4a34423f6155fb"
        "3f6903d93f81f4c63fa384a83fb0e0033fcf6dcf40186fb140194b31402779114032bc2540394b00"
        "403b5cfe40678afe406a958c40bde13540e3655640ff3d8e40ff8e2e410a58f3410bf0c24122a3ff"
        "413340244156a4634163347e416a2e5f418ae5a4419c3eb141a2817041f8880341fadb6d4271d812"
        "4292f31042f4a204435c71904363db2c437dd75d438f3c9343ec90a643f3f8be4406232e4432830a"
        "445d6bfe446e27c744cc04d84506ac004508bf6c451aabcb454124f14543a2ac4547a29045eb74a3"
        "45f4d6fe461c98b94628b6464675f52d46b6803046de84c746e43f2846f772de4703261b47093608"
        "471a796a474f4d2e479dba2447b6030447e864f6481c731648317f054834e16e48c7354f48cba74c"
        "48dcb9fc48f32506490bc07b498e4ab2499ce33a49b4b08b49d5749749d702dd49e47ab24a2c6d3a"
        "4a3066ed4a67a2eb4a7439114aa3fdf74adc45734af345254b05b9b94b26ec1c4b27254f4b539566"
        "4b7c3abf4b7d0cfc4b9490394c20dfeb4c2e356e4c4f3c694c6974944c7be5e74ca785054cca5013"
        "4cd00d954d1d0b8e4d33ec524d405d294d6060644d6310d74d7a03ac4d7acc224d8a09424d8ae425"
        "4dc1471c4dd123074dde38a54defe4cf4dfb07494e32b3724e3a38134e5485e34e8ee5a54e9897cb"
        "4eb5b1b64efae67b4f4408a64f541a484f74f8444f8ce54b4fbd49f84fbf651d4fd6cd094fee1c14"
        "50057bcb5009e1be500ab29950203a99502f1496503056ee5043f2be5046cf51504fc572509855f8"
        "5099bc3e50a90add50b04f8050b3af6e50fbf713511cd3c75144ddcf51559dd45199bfd1519a241b"
        "51c81e1c52464240527072eb52ded7a3532733a4534f0ed953d6ea5f53da01a053e7cc6253f20bc5"
        "5411c12954284ccf54383e9554a17ea854a19b0f54a4a4a454b9d03e5502eafe550c1062550c1413"
        "552ed37a553d779f554510e455481166558d2e6155a314c155c1d26455ef92be5600002456125d40"
        "56150d36565352b15658b484565f559256c15e0056ddd7a556e9e687571c85f95723834057393e52"
        "579217b057c760e1584871cb584aca1a58c56cf958cdd1c6590c95c8591ea4135969a1cd59940979"
        "59a3477f59d5a33159d9a0da59eb8da859fa3eb15a15333d5a6b406b5a995cde5ab8caee5adef279"
        "5ae8d8155af7441e5b0317d85b108a575b2480dc5b2cd4625b5f390b5b61a46e5ba4e7795bcfd46f"
        "5bd6a2545bf111845bf36c6b5bfd61f95c1276c55c4ec8775c53f55f5c69a4f95c81f6cd5c9c7f50"
        "5cc0bedb5cdf7df25cf319765d0d301d5d12318f5d15e6115d2139085d8352b65d9456285da50f55"
        "5da52f495dae35125e07a36d5e49f2d75e8ec4e25ebb48fe5f1cc0cb5f288ed45f38dee25f45b98d"
        "5f46864d5f4bc4b55f5127d55f90971b5f9a16835faa30dd5fb1d4d45fc432895fd03a3c5ff04128"
        "5ffb39da5fffd4a1600f6a2f606ca81e610746fe61085130611cedbd612f8c1f61721a0561796247"
        "61df65d061f3f09f622045206230060f6261bee66266c3a262a12eef62dd86d462e5844e62f90323"
        "6325eec8635f70e16366e56263b5f1f563c1cb89640e9a886418e83f6463e05064a7a64864ba1c69"
        "64c35ec964e1d30c64e303c36502a4e265c240cc65c5c54865c5e4e765c5eebe65dd52836605f3ee"
        "6626971f66278a276683847666b67f8666ce48e066d3b72f66fc8ab0671e86fe6729f7696742d774"
        "674357fb674e6ecb675916cd678de93a67bb57f267ccddd367e0efb967f919bc680355ce68478a56"
        "6869d6c768c6582c68c65b7268ece03668f7ca2469072873690c13576953ec3b695fd82169888e6c"
        "69c02f4c69e9c88469f20c6e6a405e176a4b26086a8b3eb26ac2908c6ad530986affeaef6b173d65"
        "6b29c1236b644a126b817e0f6b84847d6bcb907e6bd7063e6c094af06c446c6f6c4a74f46c9d4a6d"
        "6cabc2596cbdee036cc70e7c6cd603696d1142916d1fb9896d23977b6d3799fa6d4b2ef96d59c364"
        "6d80fc856db839ca6dcf81746e0c8cab6e1085d66e1973a66e2eddd86e7862a76ed0abf36ede8ce0"
        "6f5484fd6f86829f6fc3b5646ff1084b6ffa6a58700169897014e7d970208f2f705466a670546cfa"
        "7062307070678f747078e304708073ea708a98887095ea93709740db70a0a59370bba8bf70d00fc3"
        "70d1e4f570fdc459710564757105aa63710bf2077135c44c71650b3a7179ea6b71911aff71d8bf76"
        "71d9bee1720b6114721b84b772211f89724416fe7244de56725588207268db73727dc49d7289494d"
        "728eaf2d7296a00072a963a772b4550072dda85372e98f2e72f8bbd3737e811f73ac6a6873b65711"
        "73e345ca7404b2517456e05f7471b77d7492f7a57495425774ae109e74b6709374b82aae74e6ed11"
        "7506edbc75082ff1750b2f6a7561a3ab7562c3bb75667c1d756c3d26757456c47579690975a18f9f"
        "75a8b8d275b2ecf275c5a6a975e679807639647a764b340c764fd0a276626cab76648b19766fb03b"
        "7683446076ade3e576e8cc0e76fc517876fd12c477178c56771ddd3977563dfe7787ab07778b3f9c"
        "778e4fb677c492c977d2f71d780976537820a9f3784a62e5787a5d84787b8f1a78901e1a78a4e65f"
        "78d84a1278f7432c78fab88878fcdff47914f21d79844b677985aaa279aff50179ceeaf779e09dbb"
        "79fa253e7a6549207a83089b7aac276e7abf9b2b7acfc10b7adc9ad27b3629477b3cd7927b53f025"
        "7b922fed7ba18c377ba9d0017bbeb9207c33b75b7c5ede727c6009127c6080447c9e62f47ce97331"
        "7cedd7b37cf99b2d7cfeff097d89020e7db90b807dc0ec937de0cb7a7dec074b7e0f54507e32f1a6"
        "7e55e7227e5754157eb3ec217ed54d867ee128517ee4d4ea7ef435077f292d9d7f53fe197f5b0e59"
        "7fba13da800d089880166fc38032327680610c838083473380e49ca780e6ef5c80f62d9c813d33fa"
        "8143e07f814a804981a043cf81c5e06681c6178781de62bf81fa37ca823f6dbc825098b882743d74"
        "8288198a829136058299fcb282a54ff082a5c60582c5377482f1ba888315bee88352307c836dae61"
        "8372db7d83845804839b91d383dfe44e8404b1ab844d64d784618f46848308dd849467e284b01007"
        "84cee8c384d6363e84d879e88528b0cb8568714b85a2b71385e9c88f8630063a8667889a86798e2e"
        "86be719486cbd69f86d014e686d30bac86ed889087001c0b8710bb0987571029875a252d875ec3d1"
        "8791f1b087929c2f87c019da87db35488822fe598834de9988435e0d88497d6188930fcf890124b7"
        "8906e6ad8937147189389661896c7a8e8993cc1d89a2085b89ac653589c39cb18a158ae38a3de08f"
        "8a567d168a60f4f88a63d3dd8a6dc47d8acd0a2f8ad6d4fa8af2cbde8af656348b179e1e8b235086"
        "8b2dda868b310f438b392c8e8b5e4e918b70b4ec8b7372d18bf3bd158c108fe48c1b1fab8c2d030e"
        "8c5789388c5b6eb28c6212078cae393b8caf49188cd25c458ce2c23c8d074e518d0767328d61d08c"
        "8d6a13558d6d9c578d79cdae8db762328deec6e88df392d68e159e4c8e2af4ea8e56dd698e7b8c78"
        "8e86b3db8efc08748efef29f8f1364f38f20bbd98f47b7678f5f183b8fd2d4b58fd9101d8ff40398"
        "8ffab07b9013482b901b74219030a06d9030c684906bf1e190cbb68290f88883910fee329160c81c"
        "91707dd6919c239791ac1e3191da4935923c092f923dcd65927e975d92d951da92fd8d229303f816"
        "933a870393610d959380aac893a6968193c2ca4993c4f96e93d92a7d93da5cd593eef57b93fdb06d"
        "940918c7940e5aed941b974d942255fc946e959b9488ec4c949192ad94b44fe194f25302951a8fa6"
        "9532ab8195531f8d9553f8e3956964fb95b13ece95b791db95ceb10795dc1feb95dca689960c6d41"
        "960f78c896174ddd961975f09650bc2c9651c15c9652138b965317fb96ebb7fb96f211a997342145"
        "9777670e97b273f797bac45f97cd3bca97ddb71097e51c8e9830c3589839530298407fc598900cf1"
        "98b2344298bf48f598f4ab3999184536995d3b16995fad809977c34199838b8399a343eb99ae21b9"
        "99edf42c9a19b25a9a8cb6b19a9861499afb40ab9afe5d0a9b5af6489b7db4259b8d0a6c9b9c20c1"
        "9ba3ce119ba755399bc751349be4e2de9c4754619c5279819c5e2c549d3b81789d5e800e9d7e0327"
        "9d95f6959da0102b9dcd4e019ddc84ce9dea9e649e0067269ef2bdfb9f133fda9f28c9599f42c4d1"
        "9f49e2319f6e91759f86ac2f9f9a21b69f9c50db9fc8b79ea0110af3a01fd6f2a092b814a0addcb8"
        "a0b20677a0d19ac7a0dc7e23a0ea53f3a102070ca1075b6ca11893dca123a0c6a1270ddca175867e"
        "a179b677a1834525a19cd18ea1a8113ca1c3d308a1d6a73fa2065e19a26bcca8a27e429ca35210c1"
        "a36d7a9ca3a47646a3f35e15a401865ea453a34aa4c2ced5a4ce0c62a547c74ba5722b0da57a6a40"
        "a597805fa59a006ea5c6b198a5ebd3c4a5fc792fa642152aa676d4f0a68ba40ca69981b0a6dc63cf"
        "a6f7d9e9a6ff0a0da70b1ebba7214347a73c62dfa77444c6a79a10f8a79addf2a79b08f7a7a4c9c4"
        "a7bc9bc1a7c90ef1a7ea962aa7eadfb0a80806c6a808aee5a826a81ca8398b00a8568935a87b472a"
        "a8d8387ea8fd8f2aa93d3de2a93dec71a946bd5ea964b36ca96a22fba9a5e499a9b987d0a9cbf648"
        "a9dd2fe5aa27b34daa4414e2aa4ebe9aaa8e5030aabe19ecaabe8ebfaac34055aac478a9aac64984"
        "aac809e7aae292d5aaf90707ab3b0333ab46a9a7ab617808ab903be1aba4938eabdb93c8abddfb1f"
        "abfd27acac0c3fdcac4ef1a1ac62d4c6ac6c73d7ac9f6cd6aca47c40acccc26facea2864ad027e93"
        "ad083ac9ad324ac2ad5e0f3fad75712ead815b91ad91937bada50200adbb1697adc7f333ae22edf6"
        "ae38dc8eae6b77edaea296f4aedd6142aeee3915af1276a9af24ca50af897441af9d6364afaf18ee"
        "b04a08b2b0511d6cb080e39ab0b5eceeb0df9caab0fca459b10768a8b10d46d4b11f481eb195016e"
        "b1b55ccbb1d38b3eb1e70805b201dd65b217934bb22a8053b248a333b279382db290095eb2a1cff4"
        "b2b077d0b2bd984bb2d2254db2f22258b30370a3b30de278b35b2d90b374fc2db377a3d6b3a1c79c"
        "b3a22efcb3ab9facb41ea08cb4a66e4eb4c8a092b50981e5b50e8accb5553885b5671780b567330c"
        "b5680fdab576844bb5904d99b5ba4735b5c44985b5d47667b5d9b1a9b5ed5fecb5ee8507b5f3cea6"
        "b60821d0b610dd2db61b8280b637ec44b654fb6ab6a04d9cb6a06eedb6d51833b6faa38cb7208d86"
        "b72c73e8b76856d6b77fc2cfb7b74a19b7b7c0d5b7d2b922b80492f8b82997e2b8719aaeb93cc533"
        "b961fc44b968d7eeb99b1bdab9a72073b9a9a225b9e436f3b9ead430b9ef84c1b9f5922ab9f88c3a"
        "ba076622ba14c77dba44cf0cba72e96fba8ade1bba9348c3baa842babac161dfbad98bedbaffcb83"
        "bb081db4bb322ae8bb3cb3c0bb3ee21ebb81a1d2bba02509bbee487fbbeefb89bc09a7d0bc36e358"
        "bc4d4adebc6b5abebc827374bc9063dcbc9bb441bcc7f9bdbcd5d3d3bd08dd8dbd502963bd6e5267"
        "bd85b567bd8ec143bdbd8f4cbdc53016be3edbb1be4887fcbe4adbefbe62ab22be797f18be8ede65"
        "be9149e4bec00c5cbec2b7e6befc647fbf0a525cbf2bb9b3bf4dbec1bf694cb2bf8372c7bfc7ef0a"
        "bfd274d5bfee51cec008f0d8c00c8d1bc04d55b4c075b16fc09637e0c0998243c0c3680cc0cf4ac4"
        "c0d113a0c104f944c1103ce9c11b9d3ac1530056c17b80f1c1830f82c186a66ec21f7c41c2ab0e8d"
        "c2bcd319c2e69ee6c2fc608dc319e37dc323b5f3c35eeb31c373db11c398f2d1c3a3c6cbc3a6ef0b"
        "c3c997a1c3e443d4c3e53e6dc47d2bd1c4ab961ec4b36cbec4f2ce21c565793ac56f3b4ec57ad182"
        "c57dfb42c590d9eac5aa670bc5ac6011c5ba7545c5cd7fc1c5dea0fbc5f15621c6130fdcc627936d"
        "c63bd041c63ee9aec67f25cbc68dfe02c6bbaffac6c92596c6d72a00c73cef3dc74072e2c75c7248"
        "c7a6a62bc7b78f78c7bca71ac7ce7855c7ec778cc80913e6c80e4ec3c8740ff8c89623bac8a97c20"
        "c9475557c95714c5c95ccf5dc974e00bc977c741c991af15c9b2a3e1c9e0e2f0ca27ed8bca85b470"
        "cab6579fcb1ec9e8cb20536fcb40fac9cb8f42aacbad4444cbde0556cbeee3f2cc0c23e9cc3182c5"
        "cca3175accaba5d0ccdbc385ccea3a5bcd02e30bcd241712cd55a65fcd6b0d71cd71d4fccda6caf7"
        "cdce75aacdd2b2c3cde7a28acdff6a01ce4c7307ce50557cce5205cdced31f69ceeddc50cf154dad"
        "cf27d7c7cf5e0175cf735b03cf81d525cfb16ecdcfb47d84cfccdd24cff961b1d01f424dd046ffa1"
        "d062057fd082955cd0a4d875d0e0912fd12819efd15fe9ccd1a6d391d1ec3a7dd1f9ffd4d1ff6135"
        "d20d5ca5d2119288d2201f71d29a4816d2add333d2c606dad2e02e8fd2e4858ad314c40bd31bec4c"
        "d346b849d355abd6d36bee12d3a48008d3ae14fcd3d5d0f8d45779a5d46d08e8d494e2dad4dd5490"
        "d4e96406d5094ef9d53018bbd5379ad3d5f0a763d5f6aa76d626aeccd65919ead65bd592d65cf334"
        "d666be7cd67fc244d6a259d0d6a2acddd6afdaaad6c05a00d705809ed79d1d5dd7aa0611d7ab26bb"
        "d7bc1ca3d822ac6cd82aeab3d842b045d855580cd8f14e25d90d30b2d93e042ed949346dd9509ca3"
        "d98342b3d9863397d9bbbe15d9bf1497d9c529c3d9fcaf7bda194eecda3576f6da9758ebda97c6c1"
        "daa8e4d6dab78bcedb325d37db3dadfadb61a8e8db68c686db6be662db709dfcdc0a36f0dc30cb5f"
        "dc7bbd31dc9a8cb9dce08caddd4a1ffbdd5b4520dd99f6c8dda27664ddbf5dabdde168c5de06e549"
        "de334b82de4f5c28de60f96dde72730fdeba2cbadebf2ea6df318d97df4cc72fdf70569bdf7480dd"
        "df8a9f54df8db690df967410dfacd39edfe39503dff34b06dffc31d6e002b7dde00ef5d5e0174b02"
        "e024563fe0711672e09ab586e0aae5c3e0b06a2ee0bbb522e0cb14c1e0f1b8e7e0ff44bee10a308c"
        "e128044fe133a974e14bb928e16f7153e1b5107fe1d207c1e1dfbd58e219836ee21b1854e23a4172"
        "e24d3061e253b393e29b4699e29b7b81e2bd2a97e2ef0a94e326833ae342daf1e3792062e38567aa"
        "e38e6e24e3d4329ae3e2db8ee414b41fe47a7d78e492a109e495b11be4a9cde6e4c22e54e58ac1a2"
        "e5afb601e5cb733be5d9f080e5e54a2be65edd3fe6978ec4e6f732ede71e376ce7209a77e7665f8d"
        "e7745c46e7897f17e7e24cb0e7e86a07e84a5091e8527a3de855522fe8a15fe3e8a95cb3e8ac58e4"
        "e8d7cccde8eb2350e904e3dde90c7040e9112b1ee929a41ae948b56ce94d7385e950ccbde95d1648"
        "e98798fee98ff65fe9b705c9e9c522a8e9d63748e9d96a8de9e15b5ce9fbd01fea14b55dea2529e4"
        "ea7fcbedea89cc9bead7be91eada55b5eaf5a77beb02ed92eb05123feb161b16ebc19ca7ebc965a6"
        "ebd04359ec139764ec23c07cecd87f03ed038c65ed1a3bf9ed1a489eed69fe00ed6e92d5edad1841"
        "ee004f3fee1c3bb2ee59a3edee65625dee6b34e0ee7218aaee7e208eee8053d4ee93a3c7eeb2b208"
        "eeeec7d6eefc282cef0250cdef089a9cef28c92aef2e921aef394b94ef482f07ef68d6eeef8d867d"
        "efec0551eff0d1baf00666d1f05ae9a6f06b51b0f072676af0a0ababf10e2cc4f122c17ff1776948"
        "f177e59ef18a0452f1973edef19f5cbdf1ab53b7f1bb7532f232fe7cf243d260f24662bbf261263f"
        "f26452ecf26f82aff2a85c36f2e7bcadf3097408f30c3793f319179bf31d3c60f335c9f5f3528eba"
        "f3547b41f3848c92f38eb035f396e400f3a270d6f444fabcf472f36af4a8bf01f4b56fbbf4bf3744"
        "f4c5fd25f4d340e9f54941edf562d47cf5785830f58e08c6f5adccf9f5b6a255f5d5b048f5fbdc73"
        "f6381f72f65dcd47f66224bbf6742c42f696ea7ff6a5f9ccf6b4efa2f6ca0b17f6eea67bf6f48859"
        "f7003a43f70c60b6f7243614f74cf8b3f7c17cbaf8407841f846552af84de740f8564b32f873fb64"
        "f89a8709f8b192b9f8da24e4f8dd8c6ff913624ef92fc3f5f9396dfcf93efbe3f943c168f954e6bb"
        "f97343ecf97a5724f98b8543f98e050bf9afaf86f9d7ec7ff9ef0480fa457158fa4a92f6fa8f52a9"
        "fab4b2f9fab7fc18fac66bc6fb08cb78fb4100c2fb633b15fb750899fb7942f4fb8aedb4fb915557"
        "fbe9a4a8fbf999d2fc0c295efc603e1cfcd6d443fd16d5a9fd171574fd28246efd5099a0fd54283e"
        "fde89eeffdef1a9dfdf8baebfe08e17bfe0d80d1fe2ac87bfe454612fe647fd9fe6f56cffe84d1ce"
        "fe93bfcdfea043bdfea6cf3ffeaeee25ff423f8cff61685eff6dca1fffbc6a70ffe632c3fff05c9b"
    ),
    "transform": (
        "eNoNl4dXDl4YgFPSpKUhikRWGrS++96vgQai7GySRIXsrampQUuoqKSIUqrvvvdrKisiGYmQVaRIyYh+"
        "vz/gPeee877nPs9jMdLM2iB5Lp+yKQjGuv0m/UmjYGSfC36fNyDa9ngz8xSeEziNWS2IZ9/J4MI9ltZR"
        "L0l4loP17S+GtLhlFJ+nk4/Ws5LQzPgwDHwpIXfuPidbWy+zekdtUrlyFPYfOkVsP2eU2sM0m5g3kvxD"
        "+w7aWK1Idyufg2e2+7Ck641l1QeCwefc4KvBJpZ7eAyMqQGWf1WTdKcY29yuW0LvqN/goz+3ovtiNX7w"
        "dznUhCjiKEEiJG24ik2GI6Bh1ER0FxsQvbN5bM/eTGthQQRf7Tqefrj7Cep078DWVH88OM+EXRysg8l2"
        "Aphk7IK7bhqDVVA9S5VpJ6oj1ax7639BEzdkoxclMYl51WzC/HBBnM4vEvboFxEtCSNPQ08Qs/bLbP3a"
        "KhKotZJcje+j379N4sGVc+DZfG+RqgWBUIvNzNlvM4kwtGa3AyeQFlVvgal/G2m6caL0OPlDKkW64s3P"
        "jChTK2TNF8+A26TnrEnmCGvsHI4eF4daxQVHMPtzd0hj6VxiMWETmVS3stR7lprYhpnS2WOj8ONufZzs"
        "eZoNNHSQD+e+kRqLFOJ91kJUhIxdkBcwo46TpGewJ/Z9XiV2NFEWj1XU5H9WWfMP+cao/n0P/JQVAjl6"
        "F9Ssc8mkHTkw334jadmkglKxUayqV9I6w6FLvLj/Ip+W78JLbQZRhbAg2jDzLX32VJ/a2CjTUbfsYJtf"
        "LKtWM+S/r+eyhwEHxY/9KSuLf8AXF1ihoeJG3NMnZGtnJoICrSVpH7cJ7u4+BKOUIkRyaUdYu9F4LLp1"
        "VGx8Mh6OHRvG0l+eRT3tQdicq4VR9zZhkTySTSqyrPTvZ1YS9oK9nDwc2zxScf9kCXT316Lr7zuiY1Ii"
        "Weq7HltnlpHpTbrMasEZVjE2Ag+uWypQTo8SjUhfwnqcjHDGUGm0XP4L1sv5o9wjIww5p0Kcag8JnCNG"
        "wkM1bbZiyERslNHE1RdM8aS2qSjHRZH1zv5Buz3y0W/HGvjzxQFc/VLYPNNZDGxdUOfiMFx987Zo+0kq"
        "8GnyI4IUzpx3D0LHb17si9pY3j5vKA/XuC2wW5NPejQMRPrFU9Fs/BRc4KKM2raabPKadNEorTg2Yku3"
        "oCJVu6xj5DLhON80eOd5j/s7G4j9c1tx98xq1hf+m270y4IAtg3PuNnxQa5L4Ju+MS7SqxeXe49A3ZFh"
        "dKZ2NY7eH8/JvR3ot34MdZgQTk8NnCY3Kgw4r5zOH/oqwYypeuBt+VBoXpvGr2bkCc6t2kYO7xTDMGdZ"
        "prlfh5XxC1a/aBnpmSnEwm+rWcEQZ+S9ruSkUqDwR50UpzlaOMIrE34U5MCVF1KCkKnDcE+vNJ4I3UAe"
        "Zl8TrNLvZXuGpYsOCjiZIpgiLPGtF3Trnwbn6S/Q9Mxakn/7OFGq9iKqJ3+JTq8JE2R7tAqKxbJkXc9U"
        "2HO2STTXW8Qmb7Qi51QDyPy790q+qZwXLTt7mRmvW0vevuhl94fdLzFQbxD87kwiXdONyAUTKzLGOI6X"
        "3vhD3M+cA1+VNbhYfhIsn74U9/wby+IVFjAFpSBB34zDzO7FMVipG4LTXXeCkeRQ4eXBn6il3lax5toZ"
        "wrm5hvxx2Ebe9a6Uag6350Y2h+m4ocf5k7xZ9NOzSj56cSZ1q7IQrpPYS08Zr+Mfb+uC9sI0kNG25TUG"
        "e2jC0gl85Uh5+v7ZFD7xjhJtmNSFLGA2jRkrFDpWW0LFTDVa5tkiiu7YB/aLszDPVh5IUqvlNUtFuN2z"
        "kSWeJLA9MYhpjpSCryl/uXGNFN95SIb29ZXiVpstZNPyKGhKDRGdH2dPjhUeYPs/LYHgvYaizbMnwLC0"
        "K2yErAEfMqSPLdYOJwNPZpCrD6ZioFANov4+Ftgp3mc+9mJ2q/eb6L7tX6byKgwnOSSJ8k/n8dT0ZhA9"
        "u8s2pgwh7e9LmefKOIHHke1s0AZTMsvTBFf1tpf8KznI1o/ax9Z1jMeJ8sriq+7dsHN5LYZEd5ZW//3I"
        "xhufYnlfT6DKsUC4domVOFQswoWznYjkwywYrNaDWS7SwvNDb1DbIEPxUKtoSI2vontXdvKy5clQeFGB"
        "xq4fydYGHIU/s37gzco7dHZ1Nq/UjRF/jlSiBJ7wpQt6iOtmGyqVu5KPLrkOO/PXw/t1IvLTbx8c+KbP"
        "S3VNKT0/ladfLEWpB29F1wK3omPPRTA7cZmB0zIyquAahh2zgrjhziLwPseenVAkPblaZO28VexGzgT6"
        "zGCx1cXrs0hjeDHBLYdxM7eBCsXV7L7XfIGdgQXOeR9NGst6mc3kStZq2yEqKFQRjls9k//bvhEyb3ux"
        "yjtqEPezhc11fskkJk4mewftAu/C81YWDzwEEhPtUan+MxnULsfqvmzie48o4y81Ebh3XiZDigpEh6Qv"
        "EVX5i6RTTQu2h+WQuU8dMfGZH6vNv0JGnNQT3q0/yzuOTsSHJiFUXaofBl/cCx1dh1mo7HT4sa4Rccsf"
        "fF86HAWdccCOjiMViaOsHd6kiIfUz6Cn5TSF87Ovw5aBd6B41J4+vJMPHhINXPmWmP8YKUKXyf704Tt9"
        "ern/tjBh9h/eulmaOr2Np17vldivtcMFXfkOMG+PLn02zZDvs3bgfc+uYl3WJygZLAUi9XvUyugS/yjh"
        "C0kV5+DjtuFQe3I1WdHPyfnjKrBaX8bqks8optZ9Dk1TXARd5Tug79RM4dKDenx2ZARTCr1C3lvEgqpu"
        "GfO3/iqy1/nG7H8dg6S2FoGuxEYS8PUZOwrjIOe6kXjCGGU6Ib3q/71JkWvpjdjSUiNo85sGL5yHslFm"
        "EWi95Qu5di6D4LDRbOlOe7z0T4qvLjKgfGkGOuVVskc6Y9nP7GSiriCHp1G5tKqbi0of25LzU28yn7Hh"
        "zNipTZRwSgLHp+VQUdVk3H44FqXO6dLTPxxAy+sxLrIIZ1c0auCJTjKGDP+JFufrLMVFF6A07QEPWBMg"
        "zN08n/t6veNz97VQn0dO9HtQIod9C9mYafl05+xyXmCxnD9T9QJzvwC6yleTi9/9/7lur0UPzcW8R2hA"
        "PZ3Koby9Cg/9HI+2Aa/BSWoCf8JvoeMhgWCDhTb9ZKop/vKznDZrj8eqF1Pxw5kE9ixsBWyNDhBVCeeS"
        "fq10ViExVXSv+D17v0BSZH5mKKvXOy6u+GNIdX9Px6VN+WTtWI5/yxJJ+AgPgfxQFTZQtAEfHPGA3bMP"
        "k2yNMJHPwuMY+/UDf+B9mlQoh5JDX2vY6B/RZLffMqbMlMnuytEwqHpAoJhoUnKu1AXOO59m0qLLgo2f"
        "h0OL+0hBuJc2OTxcCKHDLUl62FES5h8gkP8Zzk4Xp4jk56eRy6VUFB0XRp7pV5H7Uqe4bXICtB+Pg5dO"
        "VqUdphqoM/YUBGY9YmnLDuOgg/+I1iV/aBxcghu8PhCBZBBkzX3G96wYTQ3CfxO9IzrUbFwEb9jpRs1m"
        "rKTeAyX8eFk83IgOpzsCP/Dz6sforOdz6EBQkXhPoC+tcxDj+l35kDdsJ3ZbKYHOgmjoUxpARcEOePlU"
        "ieqYHOTyU17BcO0g+P19EYx8MQr3uEyD1SdTiNllwsobrxDZB/OY6ux/AuObXRb9OzYTM2EiWTnjgejA"
        "KgKt+2fT2OMxkGqsil0XG8jrVaMFgq9GJGIFsLaTIjLCtYoJQnVJx5dugdTJAlGj6hPWYTS4PMx4EpUJ"
        "T2Lduw6xISeyyZtv6WD3IgSeyj8krNOGWK0dC/htHaY3K8LFQHeoeK9Wjr/O8S29FXQOE9D255PoOvoE"
        "nb4uIB8mHiCzrz2Ew4FTWVAnwp1kTbLn7ijBQcGM8uyeJZydcuWmjb/RXjuWGaqdhr8DT8mV0RdJ6Kcz"
        "rPboiOv9Mj/J863+IlXHi4KHe0aUq28X8i3R+6kmWQyLtULg5t1baKLWSCZFTsfkdUvhxvoVqHX/t1XQ"
        "r3/M+pw8BORK2zx/qYNWepdAye0lCT5SAQq/NGDzc0VQvq6Dc2mhaNIUDVb8qoF9jdJAt3l6JDL4lI1p"
        "vIowdbeGOJ3o8Etaj3njnNHk+ik9rl3pBHsDx3GJqCtgUvkcY1pXQnCEMleonWNjv9uM27sAfr4Xijen"
        "3i09nbAS18WeR8+xYjxx6RSzVsjCbRdk4S19wZ5tNIb9lpMEM+qarFJabzLTjHNkaKkl7L48tbTRrKl0"
        "lU85MTjjIVq0ezLJOdQrcmyaxvbWSwq6BzvAvuY7bPcEc6ANVvBOWxt1p4+DTKV4iy1H3MnX6/KCy0VB"
        "omdatmzdhVxRbU49i1wlL9TuM8AYjVT26dBlYA4quMNuKdR+y2AxsS0i/60mcEldHr9YnmZtu8PgUYAs"
        "3/dvEY/8eZY7xzXDpgnr6VH7s/zurUT63Tkbb5hqcVnVCOqU6MgdVkyD312O1DO/hI9S384aZUzRQHkc"
        "m0kl6Cm98bzmugp9NGcPUuMpeG3iJVBYFoyqTirQp1sOR9658SdrlLmRWStJaFLF73KmIF8YQ6a1e5KD"
        "s9YzqaRo8vjdQEkmfSB4Fx3PypcdZB42qtiw2pDbrPOAxx55ghmLjhGv0FbBRbd1ZEK+2KosroVECocx"
        "7ZXuguqARaxjbrrIsjeKdVmrlr3blMjduaJ4Yl80t5sdiKNP/IVYvocuXcxgfK+WqDA1Ew5S49Kq4QOo"
        "l7kWcx4K8dfVfH6k+QZji5R4pu16/HLwEV5oUcOI9o8C6xOJpGjrFKJaFEpmT7xPpto/ZLZCNfH5+2nc"
        "K3UWby5Q4yC7EAuxnagsjyJUOAia8gJgYuhpgUZfK5F53mT10kAD+ZAEvKxQw2QL69lCkZMgZHgyKVWy"
        "INGK1eznRx3mahVdYjSvhCl13xQdf6WB0RXmzND6H/0ZcYaOqx9PNzpSWj/jOLnbHYVvDOLZ7Nr37E7L"
        "BixM2EzSXd2xTTak9O8JNbgtM0e4/4wLnb93Lh3/eyStSagVmA9kg72PGjPc/YN9ed6HXRU1bFlgGtmz"
        "wwGet78iWSH3hKPsX1Nm/JBuUhxK7965A5k332BtoAl3ya7G0LHZIMOysdm5RxTQkQg/P7mDau8jYeNd"
        "aXFepw01c5RDswtmVNpuMf5N3QfnNh9hdYLdsGXBbfZs3CnmrBfAgiqngVuPhvWd1olix6FV9ECRLE+x"
        "X0eDdYdy6QMj6G4rWZ55jUN68DOcVneFNEi+xr6wN7BVJLR+FbhVvC5prjC0/w/ncz5RFYsofpYm0XBB"
        "GnfKl6bb7QJ5rBSHjogg/i7TFxx9V1trfokV+207I/Q23ySWRjXhuO19vHjBS+q+5zYfsmA7feqdxCMz"
        "iiFnaBT/LPMa04tGW9c8sxV3+oJwaNsQcbtlIX2fc5/vj06lJzU28Arz9fSVqw+/FV4Ltqt2cK/ZtiTl"
        "kLS161cpccWie1T5xRReKlpLi/fr8Jf1KnQTLcVtZS2wtK0Pq+7MgJQtr9F5QjBIfWwRpixREa8e2g7i"
        "mNek4pcebZcYiWeOaMKX62msMPkAyJ2fyW6t/SkKrnMVrd5/CeKuKYovPqfC943RNKzmPF/74SuPPljI"
        "r+4rhLp5W6ndvmXUZHUPpNAQyO1+AvsmJEGqeGbZkZBs2u2jwc3L7PnMYVn4a9twFrahgOxw+MDiD3tB"
        "wp4X/7uOM0jf94HjDxZDfuIEoW++NxEkSeOls7/xnq0GGta74wrveququTPZjWn9goV64axT+X8neppK"
        "FhxShIPKa4R/Jop5wEcHqK+yYdKrplPLkjRSnnlcZOj5GDe9iMG0Ohe81hZCarb4C2z+6eKQnhrh1iUn"
        "eL5WL0RNuwquTTch0tkI/G3G4IfLUuzAyU6Rxcca5uFxA0P7O7HAJA+9ck/QbyUr+Pi+m2hyYysNLiRQ"
        "9WMEdHmthYPGCujml0Z2utQyRRMxYuc59Ld7wiaOlhS+H7aKb3wSB/GbdFiFuReNLzoBaqv0sPlEEIs6"
        "jSxCvh5ltDnuatiCBR0hsM7CS3zGtYUGyj+Dl2cTkA/cQc95S8B9ThM0P74Al0/a85iYBu69btT/Pm1M"
        "E53c6BzPFPGcx5kwSfgFCm0nAjxtxrdeYpHemAp4kifL1PufYYf+U5TXiGMhGpFwf+I3qLpxQrg+YKRA"
        "Z38xRHxyJTet00VxzZdEa5blwkqf+TDGwxQz3J7gx9E5GDrcFCr+781NcpG0Km8u3laQBrnbm5n/p2io"
        "9utikVvaWYKMutXDMYtAvvMsrFkmhKiQBNwUnYWlM4aJTQ3t6ZSRsvzfu/FkqcsLcmJTDjxwPo5/z1Xi"
        "zwVjQM5Lle42CIPPs/vZ5ovaaNrmhPqrJNiJCX34K65a4Db0I/FTMRKFSm5kbzyVme8sdZj7eDN8qM2F"
        "3Pad2GooiXOaBwmDx0jw8bJnwSg8EssTrUvP7gWsP3qX7TbSIoUuG+BvXRK8vjJVMKz5haD55zkWNc9X"
        "+PbxVb5o+Ug4Bpfh20MnkLjaLSgR1rJ+Vx0YONBIbK2VBS4X09iPsbGi94McSfLgBOHEn9d4/5nx2Je3"
        "i1r1Tgf7DYPBa708GV/xhwhNgllG/3wc7/cRD/2WEATb6ELja5HQY8QUsU/FMv7DsZ0G/y4BlXpF+upM"
        "OWokNsOJZQux0SoAlc8v5/O6M7H9VjKbhzrWAV/DxNv1D/GCdfbCGauayU3Dr2CqcpG/W7KTflfoI3+/"
        "KtCDyTlc9CuAD9qizq30RltrLQgVl1g8YT7b1IQK53vhy/BTbNZPAU8+bUaJizcsAAk6bXYWj3KZza/7"
        "S/JxRyStX0+RFp/9n7eqB3PpKeXNcObJSvh5ORTfp52BZbHf/3eGODw5aTLffbURP7+VxrA6H+HKLUri"
        "gEdJUJcxnBp/Hky3vB8ioBMSBNnJ08jITZZshMYRjFC9hbMOXMFz9X2i39NOi6X7tvNzjWdpeVY5hjvc"
        "wQvRE+k5h7VcfMyT3g8+wRcum0bTg334pm/lUJvegTpl/kLpqBl80/RsDB+0CAIth2Huhd3wvfUZfost"
        "ATehLS6YeRYqwtOw+ttB6KTfUeJrEZX6eJi41lTC1O5kHLUlh7FHZXA39R7TzbcCg/avovgt62DOnEY2"
        "XaUDGvflIaf6/OmLcpKlIUFnPL0lipE/C78W5aNGLsAwrQmoIlFH9l/PZ4rTc8lun4tkl7YbhMvJiNE5"
        "kFZK/8F3axbDmoTn7MNnSRL72hAKL+ihkZExRDQNxUH5/pD/pACfFNnB1HhNvsfkFUlWO8jjhMNpnu1K"
        "+F3cy3xGNkPm10WYHPkaXAdV4HbPSwDeI3js6SWwod+Tbt5UDTNvDeM/r2yEo3aBgk5zKe6YmADOKt8x"
        "akcZWC3Lx5VT7sJqYSi74SJHSyJXC5vmfqFzv5+kU2adp7rGDaWzDKz4iseJPLJzFPc/OxLFdq1Wvr3G"
        "GL6yEHwbzoJ/3AbxmbMHaIbmQqL/dAR+6dpHlmUVwKBF/eR6RiebfWgRztuiim3L/cm4wSrE9m0gcbog"
        "4j+7nsDtVWOJxVtNlnJjETM6lGsVnCgBc+VdYObiYDI5bCzs2OzBXuqtwGVx39ifrGH0YtZdXu25nj8d"
        "tplXhv+EkHcn6OwlxVSxWkBVBq7Cie1lLPzCFkEpvEdpt3d4evMR8UTfemrpewn7nS6QrfqOeM85gNSx"
        "PWA5dS5c/9whMvCNAwmbzWzoCsXSWSd242pzR6546gqtxjFwae4L5rzaleS27IU+vevYfLNeVNHF2PHm"
        "MajcT4iFmxG2FMugfMJ5GjTqLsWI29ToZS6dZZTHEmfqcymSwLud53Dh5AB0OPCNWe7vZJXL+mDREUka"
        "suaAsNhNUXy1qgLuGf3vq+430CfYD7O/iGFtz1lwy7mL7/MPwR7DWJj3JR7reh7il0pD4SqRmTh9NKEP"
        "lkXS7wePYcfvr2zsXm2aIdgEfxq0ea1iCZMJi4T2IQo4S3IYrzdXE05XiecqquFw/H4MbZJ34DZ1Cdgf"
        "1AYXc+NhiYs1384CYULfCSBON1jLkpd44MUI+OW+CMf1rGS5r4sEks9XgoHyd1ZqsZfdv6CA4oHP5Ofn"
        "5JJDV8QkqMeEtWQMh/iuULFl4G86us2JT7JL5H8enYaipCxIjmrCaf5quNm/H+YcXIRrztRg210NkFVp"
        "gOMOtdx0+AnqbahP+qcKuFL9WXj3WAuWK0vz7/Nz2PbO1/B85kumuH86thVHgHxFGOSpE565c4gwX+Ej"
        "3g3ey9XPjKE26alwYPc97CTX0KtyJJ2m+I6NcH6Du/+/xaZJfyDZ+YZ4dZkkfTX9DKidHY5Pmwy5tpk0"
        "VSmqg8ALvbgrlYnG2K2imduqUIJEoeXx7eCSrsf1Dy+iQ+9Xg4btCIiq6sAh53NJ85fj4Nf1Cd8pL2Ar"
        "Xh6FO3W52Kx3jrXd0KEKF89Dg8NFfNkwAzKfPyNyzglI9M6RW9M/wM+H8tz78xF8sFeRulnocp/AKURr"
        "3V+4NGQB+F1ZwE9nO1GTW/uw8eYeMkN/GdvD4skEx35WseIOeZyzmOw6XgIuayzRMWwq6ONurgeWlNvt"
        "45PpHbIdppNzviHkme09dNo6mEplKMPMA+8wyn0+FCmkgsG6bJwtrSWUH70QtVzW8tJ6NTjSqkuzTVyw"
        "P8eQv3ojTz/7JrG0W52ofTsXlg92g6tuOhzqNYR7TdfwtynALxSEwQeN+yAfNYb7amRjSOBoWvl+n8ht"
        "liH/LrAEidTlELNJhgfJq4pjzp+gHwc6+LiY57DoeArVVk/lo4vTIHyoAzw+K40vP4+gar9CeeK//917"
        "njz/lfpE3DbyAmW6WbxOajx1e3QBl3WmwMECGfx+l4LXihJUv74YmG8Qtg65AzprktmhOcnUf+1OGDXz"
        "K549Fw5Nkdsg+18rHjLyIXUGVqSnNRRdfg2He/fWoY7EDFjbMQgXPTqPodvT8cxoSerzeR6Wz/6Jo1Ib"
        "ICHhMKYIhkDSE1u4ZliCC7yy4fCOIRjjtaB02AMJDimf0GkQxRw7c/S6b4fRWXfBI6yStacZYMuJO4Ka"
        "s5/Z7wdv4WFoFfu30wGufxoqtoqX4wURl2mPbhHmXHom0pgkREfjsezV4DFYqV0BZhmvBcfr+0nvoGxc"
        "qD8DnqapWl83CuMXFrrRgbjNmJ6dxA7vKQKW4w9Dny/HAxPaRK9TItnYPmA9t0PR8LYlPL+YQD+9eAK+"
        "O34Qbd+jKNNWAkIPX0yfcYdpu2QT/6MtsO92OJm2oYT9u3XSSja6FpYefM23bvomMF6TCty9FX0+iUnO"
        "dgPi1R0DjV99SM7RP2Rg5FuSI2EPOG0W0RomhxfwqHi0CaGmPXW4oPsteHir8QUeCtDhoF4yc+sVciBW"
        "hqmLJsNOu0Aobx0F9+6sRvtbTcL3y3TEG8+qYX6NIjVen0lP/p1Ady02IMWDHLhEFeW+AeX4JmcZ6Mwo"
        "IimthqCTqmLtffgw619VC39f3ITB87ToI61o/De8Hf8WLyb8jDm6SFzHq25fsSTiOZtzM4BZZmmKn7Uk"
        "0879scxTwZFftGjB3jNXocE8nmwflgYJ5W+J6T1rlratGfdNuISBN3sY/7evbP9aM+H+m25gd3ULX/70"
        "J1/lkM5vzN0IQ37MprN3p1ClVUBF/+rIu4qXuPqgHzqCpdgx/xHtuuCP7upL0KQknh1SWAWaMcGiR2/c"
        "0Cb3PZO99ZicGlIkMjU/hV43mlCgNUE8L8iWZF0ehgOtgfjwQB4m2iNLuWeJVaqbLW93K4JE1gYIMvpH"
        "pG8r4oTWoai3rQo+DVnAe1yMMJT/Zce+pcEJo53419AWR8U74qQWLDW9oUSs1x0nyhs6ierL8+RoOvI4"
        "3xBYNUaZBuVfwdjJC3nyxnpMSZahNvQhvPPpxPaXe/nCERxzT02m8p0rKa1YxXtmn4BfcVXQlxFJDP4d"
        "waBz6nDD3BJqNwnILsdgzJ0xjJtfdcEg5ytwCbNBrfMfDcrO5Oc8otE81AWiO19BUI4t6Bz4y45Ovki6"
        "0vfBzmn34WCxPHS0DeFP7pzBmc63hA3Rg8V5LqF8luIwKo1H6MmH3lZHV23nEcZ6vEk1kC7+KyX8+H4y"
        "XSDtxpeU5/GCuqXlB1LjUT9jNti+CRRozlwDN0x14Xb0GVgTOggGxk4my0ZMgJSR761enc0S5AW7kH/o"
        "Wj4r5QlbNraI3h4xhAZYOFHPBzks110MbvrToEMoRfPS5LDmlSSMXJpj5XFfC2Qlg6z/LatD3TBDOsSx"
        "GRIGumDv/13WXvGeHF6xFf0zZYnU7ErRG78siP9/5k97quBLRqbNCykiFFsoiOujt/Aju0q56FAQjB7W"
        "gqKV2WAyToK3pacDXCzCVXuN4cCtS3hWfq+1j8ZXVBLchKf9+rQuPxNe9+SxG6tVUPbje/bUVhXMbn1g"
        "B+1DiebbK6yiWBqKdlzj9vNaIG76CjK2/prl2E9SEHGmVLCoTwhhq1pJcWwcMda0JEYNoQJq/5vUvDpl"
        "+TfUrqwwR5+vaNoMTt8GY4FwDXFaEsiW250UXKooZaoXvC3KOseyJz8iSIZvOHv83Ye8eKpm7fX7BZeK"
        "iKBzJ4fi89h42q2qzy3lrWDJ4SMwLToebmVcxjuRunxadTKPsNMiw1dLWJcmELGCyzRaGeBAhweZ0ST5"
        "D+zFtg2ou/4pvGstJpLYgqrBlF/aGs5TZMzA1UTSWmGGuTjpQgps8PwCd70H0emPZvHtJiWC+8cGUzn3"
        "2fCrMx4T0/ZzzaY4LhgWCTlZ9dxx6iEwf5PFbTQb4eE/P75o1GGwHdlF2svN0XdcHft7PJNNlZyNw7ak"
        "wbLg87itUCSWWNVIg01M+Z5Hgdjm8xXXPFGmMd9PoklaGU6crsor5d+SOIEhrcg/SnWdbmD6vktiP3sj"
        "qlxeDJZdpuiEzazd3ZiktEVYVRitxSyTg1brF+WB/IcBGNjVBAsu1DDJNeo09c8FalbtDWycLveS8kO1"
        "X/OYlDAEGj7XkU+CRFhdvhCKRh+DpwPD4PP8VHC3jxH/VKmgNtc24kqvWF7YNI1++WzHQ3Z0wLmPm2Ct"
        "ljS/fKgcNNrcaOolHf53RAbt3XBBsMHwHrWNm08uPIrgWTqLaMOkL/hIRQqyrquRpdIFGGrib7m13Ya+"
        "j0zCQBdCJ3QniZvLRLSl7hFbJBrBUyvlaGz0J5w4dTubuOslmdRrxaOvAVz2ew2ZVXlY2TmI1p4/yXuT"
        "o/F37Gi238iYlmjm8ld/ttKb26xQz+opmo1UplN+6rLDEUexx3UKfXBdi3ffMhR2HWT82vghpCanDWrn"
        "3mVzpGtYXnSE4P4/H7LJQJ5mvQjGMe0+mDcVYfcjHX7taLDw5VtfbNCNZzHXAgQL1LvYuLy/xH+2BR4+"
        "oMXKOmvgRY8Ufhv/GsdXqYBZWQwqt0fSookVvPicFVW7GgNpvXpwXbeb+NcnkoEFJ9lm5w9sZGcZO3/P"
        "DGVjjHD8ZH/ms7xOOMnqAl/5ypnqx3aDbkUEDC70w3bT66xpQ5zozbx9kHj2KJFTMgQj7SCYp9ANGxYc"
        "5w7D+nDvw4VwxecYbvt4iqBqmCA4/zSct5sKTRmpoKxj8//7bGDMyyiYUxEEkb3eQnLpOyf6SqUXmgaD"
        "qtoEqjhvDgSk/t+by7LBZfIo2jI9BjRkBtFqDSWas2goXRtnbv0mvUL8+KkHXZacCFPcsuiTv62oeziS"
        "lKo0wvvYAtoVZw02PnNp0bhj9KvyKZo43NO62LtM7OSXREPyxLClagOlSju5yiIdMBhYBa1BGZSOV6e3"
        "RoXT5WtP0VTSTIvzxllXxYeJ82x208fT6kT5y42p0rBWxAlHwa/NCGoyd9Mpv79CtvYsWnP7LLVOK6Yy"
        "G2YJx38wFS+7akZzPu8jlsoKdIXHEmxuz2Fnnk6G3qlbqbdJHBzJsqSySpl0SXQa9SuM43Gts3i/TS1N"
        "/J8zus+uCU6rqdApVfp8JhPQhTpT+c850nTmPz3+8KsHPfjvKPf0/4Hu1XNBf5Er++K2gt3xmIuSymEk"
        "5eiVEr/ymwTXzmbk/l5y/n4VG35gI9lo0s68nq+GBz9PsoaP0fBCZgEuUBkGo83V0eeNJJtt4IGNsntA"
        "dGQpaxVMhm8bnVBZ5iRc/Xoch92sp12SamK9hrfUNtIKB6+5jGlbVen3x2b8nIwCnRI4kp+/pUPXTl/L"
        "EzpN6dwGcxp6bjFu8uwhBno/2NQPVYK4MJEgyl8SHD4PJdJTjrNZVyRQpCeJ7wva2Yk7hqD+Kh0i3xqg"
        "t/1eUlEkQLsHozFr6xBYffkbDgpSpAv4eux2iYWXUyowb28ShHNpjoWV4s9NnNt/+0bVeiz5qgY5jNVc"
        "Sls6lvC0uw70bv46fiiB0ClW2/hwhXAa35/Kq7U/weejO4RPVztBwORgsjWF8vhdnwXlS5NI8vInWCnO"
        "4OKIWNw5dycvmxDNI9Ki+FvHwrLJXY+F2p1R3LjDiz8dkcWHr/4LfeNTMWiFBVotPcqDzAW4wUqbmx1M"
        "5XYDX/ioSbll0i03hZ2h6mL15dpc7XU01zqQRE9fukuOyZzGFUb+vH5LEq7dtgRjLKO5r5eIY6QK//oj"
        "GRRn/GaPworR/0YEzq85CQb9l/FhQRNuu6CHUlMtkG6NRt+il7g+ZQMq6+20nn7fXXx+8kOquvYjHFwh"
        "oOl+obxi9BdBbuwLQe6OVvB13IFpz+JwH5kEK8YaUGmvIdazT6uLXY216Sm9hv8zZQDGb44nvS2z2J61"
        "g4nt7XHQ3nYYVG4+IlKbrGhCui79CzJll7tV6J5HobxbbRLRL/RE91IP2G79WbCo8jLU7CyCqI9LwHld"
        "NQzqfwa3S6/C6kXyZTWuP6isty8xlj6L00PS8exMN7LvgwrfkzUIlnzzFhll9JHZY1eCu0YbO+JkjFkZ"
        "nWKl877Co3V3uNfDUDy1p415zKuEMZMPQez3PWz3y8+C7FW6AquPV/CkQqJggYFv6WWvJ8IRb1XEa8Lk"
        "cFDOLmz+lkN/TfwC1UVKNCVjDVqpxuO/oONs8O+/zHBKOtE07RfcKuTW2ruUy6au3yqcvfQBbayToo9S"
        "o3hUehDoeJbB1Ak29I18E0o5quCCiln4aWcl5N0ZWeY/KleoKfcbe/76w0HZOj7h1mg+zMGDh8qEksuX"
        "MkiSXCRs8P0NmXVLwdVsN/6q/7+c67iwyPo0780K4bM8Zbnmpy9Mdnge7izJxKNSA+g3fSlU2C/Avfpj"
        "QEHFHsf8nVtWOHun8M1ExmVpCl/ursqfO6fTkMgpzE4/EF22GPGPhjEkw1MTZ0qbYP+w57itO1mcZlPA"
        "he/P0PUFJ6A7qIDv3PECpPca0TFphKdNk+Te32OoQakT2iZt5mWWZXBm4QX60CKRhCfuhACtCaL0ZF8c"
        "enwM01HPg98ttqh0Qg3Pm+cy4jTTany3Mqw9Pw2uei8TXv2fXeTVG0j8fYyEN5+EstHvRBNyCwSHAkzJ"
        "gMNL0quljO8DRonM5E7Cwg4lqwj/NmqlO5r6bYzmWbZBeO1DA90rV4pnVy3ndR1L6DFZezpm7g5+d1Au"
        "xGMgpD59gKlFAL+v3ITFbSfQfVMwW3dsNQmVGwIlEvZY3qYDS/sDSdjBp8yreD+4FsvBwY+n2b8CSXHy"
        "3ghSNKANV2UM4bGlPH81ZzpRFwuAzV6EzlfjcUYXAYlxrrjNVQp+270gIT1G4mt3q3llaAg9l6NAr/2o"
        "5X/O9YPnWiM6qmsUJ7o2/EVbIF0wsxRVNrhwV9F7cqD0hfDI8MFiVakpwnmp48S7nIvphqOlfBrZSYcr"
        "rOMroh5Ctv54zhaFws0/Wjzr5B/WHpkp/JgZxpNXNdHx2Q3cxiGIeisP5nuTFtC+Vk/eMyodBvp+4UeV"
        "fpiSWY1ac+Lx21wZa7FGCM/YYiN8tbmfb9jiTQvsd/It/7xpzQ0FPnNZFexWmYHLNHJgyndzXH1PgNcL"
        "9cURr8bQhTeH0wXHn2O9ZCFRfF/Neua9hrfjekWy21ayyJCVaDRPCNlzAolZdTrstbsn9hbE0rHutuL8"
        "8EHCXRnHuF7qDrpx+Rle6G5KH7J43NKnTqWO2qBFzHUou5ZJHuv0iwtrZ1HVN9ZiWfkJQlWbCL6lOYSq"
        "60byxA43SqIicd6Rn6DQps752Fh4HX4N1rNSzhoDaUH0SPHCybpCp1t5/O/hELru5SF+flIQfX1DmkfJ"
        "vIAHPRqcHf0Grw5MZmWXHIXdXTf5ku9C/lmila4PteDrj/ry5g9qtO6LD81PCOYbPpqDl3kAjVg8mgY0"
        "xfAhY6XEIfar8Y/NSP7MJAXcb6ih6y9Jku2rh9dfx0DfzAhUtO9l+9/fILYaLmihH4R76V1qqJLK0505"
        "axFmi9YoRUDFlVRUS0hmqloyGHVtAgTELEH7wHRcuaYAT61PAXWfIOGyX4PEY0X3aGlKLT9yw4pWPFOl"
        "e4SvcILyEr7DKIwWvInGns8B3G+8Lm7U2kiPlKylfbmqdPOdGBAdlMBBXtthxouPTN0rVFSm7IXHU0Rk"
        "kfMp9uF+MV6cfxQfzj0KQzt+c7v3lVRtkwkvuhQNg1bFY92bs4SsdyB/jJQprOF4dI0b2VwwGiz8LEmZ"
        "pjJninbic9/G8jOKW3l7Xxf1swvjqk8rcfvnMpihZ0tflfnzjPIHMBB5mm6fqULXLfHj3cyfh00Lpiq3"
        "tXn08a7SvpgsmHg8Br9u0wYyVYpFERTNL/sE5oVd6LJGhsqekIWOq8uFsfEf+T3xB/i0XA6uKuiwNHNr"
        "Mr01gZHbdmTKwQ3kmbQpq4rdBlfmm7PtSeGwcE8EPVV4At4EKGCuUQRsWvePZc4UQMCrZHL8pbTA5G6m"
        "aPD0YWzjGxtmnXWTHdy1kGWfHCEOAIY35kTQ374j+Mxh0/jWMD/qekyS11flELOXN6H4hTW/cMWD3ipb"
        "xJufuOGQrDTaYxEBjq6KNO9Oh5VrgReetjyKZ9om4Tjli2TUtuulnvc0MHcOglXNXCIVqc7+Ge+mM2+e"
        "wrCBU3xN6S1YntBFCs/lQkqJJmR01bP4FAnesjUf+qzL8ZSUHFXZ84x4hw8pe6KnIny7RFW8I6gX3m0J"
        "pFKBd7nq1T9wYMRp8u6vKya/C6aLLxTyikNO9ABTw7IigfXekBs8Lu44XflpFL1XKcvVL27HqVGSfPqc"
        "72A8ZBy9/ucZ9Heoocc7BzC4fRJ/vpe21nhjLvbWUadpe6fQ3v2KtHb4fHY7NQEai7xYQuwGcB6iLsro"
        "LSVdvwLRJqFKJPAkZaEzbPjz9XLimEM1pQ1OhfTqXGc6WOxHo/W3YMN0d77UI5YvcB2BK3e8YdeaXGmp"
        "7pWy3hd3hPaBmuIq40HivOlJXPZkABX+rkXNv5aYHbuR56Y+hauHQ8Gxj9LcS1k4+aW6+HBvF3WMuEA/"
        "N52CostX+dzvRXzBald+NbFAUHZzAhX8HENLriM5EdVnWft+MT63+CcM+DKPXww8ii+vS1BNh0/g9HQf"
        "ZoR8tjq/qhOXXE6F80pIJlpJ0FCJJJzKiVUGbRJSg7Hi1pdD6c8v3UxlVxQ88ikhvSYJUJj8ABLtlmHx"
        "/Wwcsvs2/pmyhtWPfS8KsY2BMTYyvEVyGm1vOcTTlv8D/6qfmKBbBwrrDzG+LxElQhVAFqzg45UJPOXA"
        "bFoz/SW17pvP0y9bgtrBPaTZ+wOL9FyLt9ONMehlITOszyH3ZeSw6bom+KS9JGn+T9iPHalUNE0Vb67p"
        "QF9BPZm5dBTq6RvBVqUAXJiQwOwntpPR1+TRp0Edr4e+hjpFGX688C4G75fghtduYaN5IG36l8c1e5ZQ"
        "xydvSM3ecbz9iQNVHnsVFbw4tpGV9GCtOa96sJ6O1T5DfsJ4ePrKHQK5EosZbM+Y6U8i38UEjzXMIG9z"
        "PdleaYQpqlnExK2cFcBa4ZgrZiheY07XDfPiNhtOUm3/IfzljnDmG/MZ2n5k48YTT8nDbhk6xl2Dj70p"
        "QSVVXMXfZhyjHn3ZomLzU/zsxxi69tAiHuHbR07LydL9tQu427rTsE/OlD4PO8Gnzi2i55e1iPdmCnja"
        "ChGfaJLHvyZd4i7bH7DgnLHs9pu7UFr9ElwahLTif9YGTTdHD7MOVO1xFytPCEGZgsl8vqc8uT0xknlb"
        "h+Dz8xNxhUkvvjPuQ7dVkfhm1llcXJcK5vcl6NTF1tYFxR/ovO5L9FbYSqo3L4h6bdfFMzfMuHjcLl49"
        "1p7v8YrmgSrbuGDTaLxt0c5KPCqpfZqW0NpOmuopJtO3Gn9gY5MOtWqLEEiPa4IRBnO4/eIp/N0NAZd8"
        "78Vfjz/Cb+1ZWhYwOpN1P7rEheG38IBqHA/2U6B/Q5bSUWe8qYrlaFqzL50q6RtCUo4HN3QP5Jegma86"
        "UcFro2fx2KXW3Gf5U1w3bqFoxlw/iP0yBPYv/QCha9/DmVVGdMQDffoo8Tr0B/zg66cNFrbdl6WRHVU4"
        "TW01PJy6HG+VaPJEz2I0/F+I7LoSISN4Fm38VE0vXC2llee9hN/vCPmd5iTev6AT5k5ZQ5/aB+ODjGMg"
        "8S8Nvavk6asDlhR3duGn15r87tONfLU0E2saFNMsraXUXe8s6bm/EH2PtZITx0NB31Nk1fU7F/cZ3sUc"
        "WznU8rAUqJYsQclJb6liOaWVrhOE3aZu/ASTFg/srKbKzmX8TdAWGt8zh+93zuSig6Y0ad4gumnBSars"
        "myaUn6gnHlq9lz64kYVbUmJx+tThENpfRiYGHSZBZ7pJacgnNqNtN8huzgXLfgda6XdbLO44jUquy8T/"
        "YjZDz54LNEktmc9/bE6n2xvzv4nSdPP8UBqmPIy37akRZXw7jo7h38SPXWbSkuUX6J3Ns+DzOzeYUavN"
        "fTwnctlPKpD4xBMOdSmA9dSLkPBqIq4+2oZ+7UutDab2Q8QWf4iZW4bm35KJ0aQiEKVr0P7u60zu600U"
        "WqnwQ9YE97+9g1vnzcGChXXCbQuT6YGyVDh1ewl/7i0H9z4HcfXvmXR+xmbQXOojco3P46ZD13OrLYeB"
        "3IyGT9ugrPVKI5rnmNLxDx+TbTJ+eOiiA7y8NQw3J9pxdc+l4GFYBD/mDwbWq8Dr+xVxbv11oVAuRrxp"
        "41SqEBMPWdUD5NnWEDoxVVr8uUGNRz3px3tdF+jAvY20LXY8N7ggzYPavgvnyg0V76vK4/kmZlTQ2ASn"
        "SBVUv3DhSnsL4KzaIlR/4g/WCmI817wdfp7qZw4y+8skZl4SVtaKuVJcEu4am86rEuqQW56nP+92wPa6"
        "CGaxS4NnVD5DvUZTejvCBc4dlyt7qBKNm80y6YP1KkyTCui/PMQQg2xYKh/Ivr6JgC/5MfjIW4u6+07D"
        "a4lXIbr6mjWoneR55XWw8Oo10mF3HhY6+kPE21dsXViv4EChFVSzJzB+IIO8WaoOjbUPBGsOa9q09fhz"
        "BfQG+1kLeUPwdDBXu4cbpnTBauvB/KLnRhq50J7/OLuSdjwxYwU7hPDWcEuZ3w0Qz9izjXaMeQxfXL9a"
        "5i5X5A6SB3Df2lZUKDiN3sEVZIN0s9XhcdfJZttIMt7Lovxv4zEufH4I96q/4pITM7FqoTysGRfGi72j"
        "qHr7Z17YLKKfDyuIi5tXUsXnQ/n2Q/lCVhsEin928uORbrBy7yZerPgL7FqG44OyQVDvfhp+bkpAQ3N7"
        "9mR6Kr4fHYiSE8fa2K4oJSWSHrRGGEc15dKpit8tnO00hZZfdebto/xoxtEIXniO0fT5w/iBISYQItxq"
        "Xeo5TThfdjwdveUYhNieEdQcnw3qYT1wcekrWHT5Ljty/zUEeqzHeZ0KUKjtKZDx0iuPdZYUNv66g1Fb"
        "IkBJaqvohsI8OvF6HBvwuQyelWPI9KEPYLzIk90KGg9vpr0VFTV3lwm+jhMy7Wi89Gka3dBQzew988DR"
        "u4/USF/Ga69MqNEyWwpD9lOtoStpW242XZxFrWe8OE5X9VXT7IoNfPwRFdryolY0KdiXJktUg9vOdnJ7"
        "SgO5GuNCR0wYQR8OdsX3uqXWy8xO0qeeesKi2gN8zUonmhavQh/U74fi3ONUen20wEzSARpO23DFpEZs"
        "WdbMbaP+isM0xlBx+WOeo9BFW+/IcelzM2hEuwr3fPIcxppM5P8ehmGJay33DijgzjYB/7dSUZluLoG+"
        "9ZpizcJnML1+F3+heRPZE33e0RLHs2YKuGOLNndJqcANtSuZkslEGnBrtbhoykzxlV97qXAm5btXVZPr"
        "l8J51wx9vniWPf/dnsdOerRjo9FtqEl5DVVrPWiA5Ftrg8KF4vbR1TDnSjvP2BYBjFjwcY8n00vuDpDw"
        "TJtO3DAEEjPVqKR9P8ksecD+A+ZpmLo="
    ),
}
TOY_BATCH, TOY_SECONDS = 1024, 10.0
TOY_LATTICE_UTTS, TOY_LATTICE_MAX_ACTIVE = 16, 256
GMM_MAX_ERRORS = 2  # 0.07 % of 2,868 words; the JAX package makes 0 with tri.mdl
GMM_TOL = (2e-3, 2e-3)  # |kernel - plain| <= atol + rtol·|plain| (tests/test_ops.py)
MFCC_TOL = 1e-3  # |kernel - plain| on every cepstrum (tests/test_ops.py: 1e-3 + 1e-3·|ref|)
MFCC_TOL64 = 1e-4  # |kernel - plain version run in float64|
VTLN_WARPS = (0.9, 1.1)  # K2 held on the mel tables warped by these factors


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps: int = 30, warm: int = 3, plug=None) -> float:
    """Mean device time of fn() over `reps` back-to-back launches, by CUDA
    events.  `plug`, a square matrix, is multiplied by itself first: while the
    card works on that long product the host queues all the launches, so the
    events see the device's time and not the host's launch rate.  Inputs stay
    in L2 between launches, as they do for the callers on the main path,
    which have just produced them."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if plug is not None:
        torch.mm(plug, plug)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ali_digest(tids) -> str:
    """An alignment's digest, as ALIGN_CPU_DIGESTS holds them."""
    return FAILED_DIGEST if tids is None else f"{zlib.crc32(tids.astype('<i4').tobytes()):08x}"


def cpu_digests(name: str) -> list:
    d = re.sub(r"\s", "", ALIGN_CPU_DIGESTS[name])
    return [d[i: i + 8] for i in range(0, len(d), 8)]


def alignment_agreement(np, alignments: dict, committed: dict, label, committed_label
                        ) -> tuple:
    """(frames with the same label, frames compared) between `alignments`
    and a committed alignment ({utt: tids}), each through its own model's
    tid → label array (pdf or phone)."""
    same = compared = 0
    for k, a in alignments.items():
        if k in committed:
            b = np.asarray(committed[k])
            n = min(len(a), len(b))
            same += int((label[a[:n]] == committed_label[b[:n]]).sum())
            compared += n
    return same, compared


def end_state_words(np, csr, res) -> list:
    """The words on the eps path from a lattice-mode decode's end state to
    the final state (`final_olabels`), its end state found again among its
    last frame's kept states as decode_batch chooses it.  The decoder's
    words end with them; lat.lattice_from_decode, like the JAX package's,
    gives a lattice's finals no words (ROADMAP queue 3), so its best path
    plus these is the decoder's words."""
    states, costs = res.frame_states[-1], res.frame_costs[-1]
    fw = np.where(np.isfinite(csr.final_weight), csr.final_weight, 1e10)
    total = np.where(states >= 0, costs + fw[np.maximum(states, 0)], np.inf)
    if not total.min() < 1e10:
        return []
    return list(csr.final_olabels[int(states[np.argmin(total)])])


def check_gather(torch, gather, plain, cases, seed: int = 0):
    """K1 against its plain version: exact, out-of-range indices included.
    A case (b, p, e, T, t) takes the table as frame t of a [b, T, p] tensor,
    row-strided as the decoder passes it (T = 1: contiguous)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    for b, p, e, T, t in cases:
        table = torch.randn((b, T, p), device="cuda", generator=gen)[:, t]
        idx = torch.randint(-3, p + 3, (b, e), device="cuda", generator=gen,
                            dtype=torch.int32)
        out = gather(table, idx)
        torch.cuda.synchronize()
        ref = plain(table, idx)
        if out.shape != ref.shape or not torch.equal(out, ref):
            raise RuntimeError(f"gather kernel disagrees at {(b, p, e, T, t)}")
        worst = max(worst, float((out - ref).abs().max()))
    return worst


def check_mfcc(torch, fused, reference, cases):
    """K2 against its plain version at speech-like amplitudes, atol MFCC_TOL,
    and against the plain version run in float64 (tables with the exact
    DFT), atol MFCC_TOL64.  A case (frames, weights, weights64, fp32) with
    fp32 False is held against the float64 plain version only: the fp32
    plain version's own distance from it is returned for such a case.
    Returns (worst |Δ| against fp32, worst |Δ| against float64,
    {shape: the fp32 plain version's |Δ| from float64} of those cases)."""
    worst = worst64 = 0.0
    plain_own = {}
    for frames, weights, weights64, fp32 in cases:
        out = fused(frames, weights)
        torch.cuda.synchronize()
        ref = reference(frames, weights)
        ref64 = reference(frames.double(), weights64)
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"mfcc kernel output bad at {tuple(frames.shape)}")
        err = float((out - ref).abs().max())
        err64 = float((out.double() - ref64).abs().max())
        if (fp32 and err > MFCC_TOL) or err64 > MFCC_TOL64:
            raise RuntimeError(f"mfcc kernel off by {err} (> {MFCC_TOL}) or {err64} "
                               f"from float64 (> {MFCC_TOL64}) at {tuple(frames.shape)}")
        if fp32:
            worst = max(worst, err)
        else:
            plain_own["x".join(map(str, frames.shape))] = float(
                (ref.double() - ref64).abs().max())
        worst64 = max(worst64, err64)
    return worst, worst64, plain_own


def mfcc_flops(n: int, w: int, spans: int, nb: int, c: int) -> int:
    """float64 operations of the "fft" route for n frames of window w: the
    W/2-point complex FFT (5·M·log2 M), the split (10 a bin) and the power
    (3 a bin), the span sums (2 a kept product) and the DCT."""
    m = w // 2
    return n * (5 * m * (m.bit_length() - 1) + 13 * m + 2 * spans + 2 * nb * c)


def check_refusals(torch, gather, fused, weights) -> int:
    """On CUDA tensors the wrappers refuse what their kernels cannot read,
    before any launch.  Returns the number of refusals seen."""
    cases = [
        ("contiguous", lambda: gather(
            torch.zeros((4, 10), device="cuda")[:, ::2],
            torch.zeros((4, 6), dtype=torch.int32, device="cuda")[:, ::2])),
        # a 100 ms window at 16 kHz pads to W = 2048: one tile of frames
        # no longer fits a block's shared memory
        ("shared memory", lambda: fused(
            torch.zeros((4, 2048), device="cuda"),
            (torch.zeros((2048, 1024), device="cuda"),
             torch.zeros((2048, 1024), device="cuda"),
             torch.zeros((1024, weights[2].shape[1]), device="cuda"), weights[3]))),
        # a filterbank that is not made of triangles: its spans overflow the
        # kernel's span table
        ("span table", lambda: fused(
            torch.zeros((4, weights[0].shape[0]), device="cuda"),
            (weights[0], weights[1], torch.ones_like(weights[2]), weights[3]))),
    ]
    before = gather.launches, fused.launches
    for word, call in cases:
        try:
            call()
        except ValueError as e:
            if word not in str(e):
                raise
        else:
            raise RuntimeError(f"a wrapper did not refuse: {word}")
    if (gather.launches, fused.launches) != before:
        raise RuntimeError("a refused call was counted as a launch")
    return len(cases)


def check_gmm(torch, kernel, plain, cases):
    """K3 against its plain version: returns (worst |Δ|, worst |Δ| over its
    allowance atol + rtol·|plain|); raises above the allowance."""
    atol, rtol = GMM_TOL
    worst = worst_share = 0.0
    for feats, weights in cases:
        out = kernel(feats, weights)
        torch.cuda.synchronize()
        ref = plain(feats, weights)
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"gmm kernel output bad at {tuple(feats.shape)}")
        err = (out - ref).abs()
        share = float((err / (atol + rtol * ref.abs())).max())
        worst, worst_share = max(worst, float(err.max())), max(worst_share, share)
        if share > 1.0:
            raise RuntimeError(f"gmm kernel off by {float(err.max())} at "
                               f"{tuple(feats.shape)} ({share:.3f} of its allowance)")
        del out, ref, err
    return worst, worst_share


def k3_at(torch, kernel, plain, gw, x, plug) -> dict:
    """K3 on frames x [N, D] with packed rows gw: held against its plain
    version, then timed (kernel; plain version, chunked; the product alone,
    torch.matmul of the [N, K] frame rows by the packed [columns, K] rows in
    fp32, TF32 off, without the logsumexp), with its bound: the larger of
    three TF32 products at 495 TFLOP/s and its bytes at 3.35 TB/s."""
    err, share = check_gmm(torch, kernel, plain, [(x, gw)])
    n, d = x.shape
    flops = 2 * n * gw.num_gauss * (2 * d + 1)
    nbytes = 4 * (n * d + n * gw.num_pdfs) + sum(
        t.numel() * t.element_size()
        for t in (gw.tiles, gw.segments, gw.seg_offsets, gw.work, gw.work_offsets))
    ops_ms = 1e3 * TF32_SPLIT_PRODUCTS * flops / H100_TF32_FLOPS
    bytes_ms = 1e3 * nbytes / H100_HBM_BYTES_PER_S
    ext = torch.zeros((n, gw.depth), device="cuda")
    ext[:, :d], ext[:, d:2 * d], ext[:, 2 * d] = x, x * x, 1.0
    cols_t = sum(gw.columns()).T.contiguous()
    out = {"shape": {"frames": n, "dim": d, "pdfs": gw.num_pdfs, "gaussians": gw.num_gauss,
                     "tiles": gw.num_tiles, "padded_mixtures": gw.max_mix},
           "max_abs_err": err, "worst_share_of_tolerance": share,
           "kernel_ms": time_ms(torch, lambda: kernel(x, gw), reps=5, plug=plug),
           "plain_ms": time_ms(torch, lambda: plain(x, gw), reps=1, warm=1, plug=plug),
           "library_ms": None,
           "product_only_ms": time_ms(torch, lambda: torch.matmul(ext, cols_t), reps=5,
                                      plug=plug),
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "flops": flops, "bytes": nbytes}
    del ext, cols_t
    return out


def check_gmm_refusals(torch, kernel, feats, weights, wide) -> int:
    """The K3 wrapper refuses a strided, a float64 and a host-side input,
    and a model of feature dim 48 (`wide`), whose staged tiles do not fit a
    block's shared memory, before any launch."""
    cases = [
        (ValueError, lambda: kernel(feats.t().contiguous().t(), weights)),
        (TypeError, lambda: kernel(feats.double(), weights)),
        (ValueError, lambda: kernel(feats.cpu(), weights)),
        (ValueError, lambda: kernel(torch.zeros((8, wide.dim), device="cuda"), wide)),
    ]
    before = kernel.launches
    for exc, call in cases:
        try:
            call()
        except exc:
            pass
        else:
            raise RuntimeError(f"the gmm wrapper did not refuse ({exc.__name__})")
    if kernel.launches != before:
        raise RuntimeError("a refused gmm call was counted as a launch")
    return len(cases)


def ptxas_by_entry(log: str) -> dict:
    """Registers and spills of each kernel entry in an `nvcc -Xptxas -v`
    report: {mangled entry name: "..."}."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            key = m.group(1)
        elif key and ("registers" in line or "spill" in line):
            out[key] = " ".join(filter(None, [out.get(key), line.split(":")[-1].strip()]))
    return out


def ptxas_by_depth(log: str) -> dict:
    """Registers and spills of each depth K that csrc/gmm.cu is built for,
    from its `nvcc -Xptxas -v` report: {"K=80": "...", ...}."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?ILi(\d+)E", line)
        if m:
            key = f"K={m.group(1)}"
        elif key and ("registers" in line or "spill" in line):
            out[key] = " ".join(filter(None, [out.get(key), line.split(":")[-1].strip()]))
    return out


def decode_graph_of(tree, tm):
    """The minilib decoding graph of a tree (mkgraph_csr on the pruned
    trigram and the 20k-word lang bundle), host work only, in a process of
    its own: (the CsrGraph, the seconds of its stages)."""
    from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
    from old_kaldi_git_tpu_torch.recipes import minilib

    t0 = time.perf_counter()
    lang = minilib.make_lang(minilib.MinilibOptions())
    g = minilib._grammar("exp/minilib", lang)
    tim = {"graph_lang_and_g_seconds": time.perf_counter() - t0}
    csr = mkgraph_csr(lang, g, tree, tm, timings=tim)
    tim["graph_seconds"] = time.perf_counter() - t0
    return csr, tim


def random_gmm(np, convert, dev, num_pdfs: int, dim: int, seed: int):
    """A random GMM with an odd pdf count and 1-150 Gaussians a pdf."""
    rng = np.random.default_rng(seed)
    return gmm_from_mix(np, convert, dev, [150 if i == 7 else int(rng.integers(1, 151))
                                           for i in range(num_pdfs)], dim, rng)


def gmm_from_mix(np, convert, dev, mix, dim: int, rng):
    """A random GMM with the given Gaussian count for each pdf."""
    pdfs = []
    for m in mix:
        w = rng.random(m) + 0.1
        pdfs.append((w / w.sum(), rng.normal(size=(m, dim)) * 2,
                     0.3 + rng.random((m, dim))))
    return convert.am_diag_gmm_from_jax(pdfs, device=dev)


def search_profile(torch, decode, loglikes, nf, frames: int) -> dict:
    """Device-busy share of the first `frames` frames of one chunk's search."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    ll = loglikes[:, :frames].contiguous()
    nf = np.minimum(nf, frames)

    def window() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(ll, nf)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = window()
    unprofiled_s = window()
    # device-side rows only (kernels, memcpy, memset): the host-side ops carry
    # their kernels' time a second time
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"frames": frames, "window_seconds_profiled": profiled_s,
            "window_seconds_unprofiled": unprofiled_s,
            "device_busy_seconds": busy_s if rows else "not measured",
            "device_busy_share_of_unprofiled_window":
                busy_s / unprofiled_s if rows else "not measured",
            "device_launches": sum(r[1] for r in rows),
            "top_kernels_us_count_name": [[round(r[0], 1), r[1], r[2][:90]]
                                          for r in rows[:12]]}


def rescore_trace(torch, np, minilib, decode_batch_tokens, ViterbiOptions,
                  pad_feature_batch, AmNnet, system, traced, dev) -> dict:
    """For each of the `traced` rescore utterances: its rescore batch's
    loglikes computed on the CPU (front end and TDNN), then the search with
    lattice records over that utterance's row, once on the card and once on
    the CPU; and how far the card's loglikes are from the CPU's, with the
    card's TDNN on the card's features and on the CPU's.  Equal counts from
    the two searches over the same loglikes put a difference between the
    devices in the acoustic float order, not in the search."""
    waves, _ = minilib.make_test_set(minilib.MinilibOptions(), noise=RESCORE["noise"])
    keys_all = sorted(waves)[:RESCORE["num_utts"]]
    # the recipe's batches follow the frame counts, which the card gives
    card_feats = minilib.compute_feats({k: waves[k] for k in keys_all}, device=dev)
    by_dur = sorted(card_feats, key=lambda k: card_feats[k].shape[0])
    am_cpu = AmNnet.load("exp/minilib/final.am", device="cpu")
    vopts = ViterbiOptions(beam=BEAM, max_active=RESCORE_MAX_ACTIVE, acoustic_scale=1.0)
    out = {}
    for u in traced:
        i = by_dur.index(u) // RESCORE_BATCH * RESCORE_BATCH
        bkeys = by_dur[i: i + RESCORE_BATCH]
        feats = {"cpu": minilib.compute_feats({k: waves[k] for k in bkeys}, device="cpu"),
                 dev: {k: card_feats[k] for k in bkeys}}
        padded = {}
        for d, f in feats.items():  # the recipe's batch: T to a multiple of 128
            keys, x, nf = pad_feature_batch(f)
            padded[d] = np.pad(x, ((0, 0), (0, -(-x.shape[1] // 128) * 128 - x.shape[1]),
                                   (0, 0)))
        b = keys.index(u)
        n = int(nf[b])
        ll_cpu = am_cpu.loglikes_batch(padded["cpu"])[b: b + 1]
        ll_card = system.am.loglikes_batch(padded[dev])[b: b + 1]
        ll_card_on_cpu_feats = system.am.loglikes_batch(padded["cpu"])[b: b + 1]
        trace = {"frames": n}
        for name, ll, d in (("card_search_on_cpu_loglikes", ll_cpu.to(dev), dev),
                            ("cpu_search_on_cpu_loglikes", ll_cpu, "cpu"),
                            ("card_search_on_card_loglikes", ll_card, dev)):
            res = decode_batch_tokens(system.csr, ll, nf[b: b + 1], vopts,
                                      want_lattice=True, lattice_beam=8.0, device=d)[0]
            trace[name] = (None if res is None or res.token_lattice is None
                           else int((res.token_lattice.arc >= 0).sum()))
        trace["max_abs_loglike_diff_card_vs_cpu"] = float(
            (ll_card.cpu() - ll_cpu)[:, :n].abs().max())
        trace["max_abs_loglike_diff_card_tdnn_on_cpu_features"] = float(
            (ll_card_on_cpu_feats.cpu() - ll_cpu)[:, :n].abs().max())
        out[u] = trace
    return out


def stream_words(torch, dec, feats, chunk):
    """Each utterance's batch features fed to a streaming decoder `chunk`
    frames at a time: ({utt: word ids}, wall seconds of the feeding and the
    best path, search frames)."""
    words, wall, frames = {}, 0.0, 0
    for k in sorted(feats):
        f = feats[k]
        dec.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, len(f), chunk):
            dec.advance(f[lo: lo + chunk], final=lo + chunk >= len(f))
        words[k] = dec.best_words()
        wall += time.perf_counter() - t0
        frames += -(-len(f) // dec.fsf)
    return words, wall, frames


# sequence training (phases train_e2e, train_semisup, train_mmi,
# train_discriminative): the JAX package's tests' flows at yesno scale, and
# minilib at full width, cut in utterances where the time asks
# minilib utterances of the semisup (each half), MMI and sMBR runs: 32, cut
# from 64 for time (PERF.md §4)
SEQ_UTTS = 32
E2E_MINILIB_EPOCHS = 2
E2E_MINILIB_UTTS = 150  # of the 600 training utterances, cut for time (PERF.md §4)
# yesno semi-supervised training: the JAX slow test's flow from init 0 (the
# gated run), and from init 1 as a record (inits 2-3 cut for time: PERF.md
# §4).  A 30-step seed is as sensitive to its initial draw in the JAX
# package (its inits 0-3 give seeds at 0, 68, 53 and 5 % WER) as in the
# port, and 6 test utterances hold 19 words
SEMISUP_YESNO_INITS = (0, 1)
NUM_LE_DEN_TOL = 1e-3  # num ≤ den + this on random or trained logits (tests/test_semisup.py)
EBW_MEAN_TOL = 1e-6  # EBW's means after one iteration, card vs CPU from the same lattices
DISC_GRAD_TOL = 1e-5  # discriminative_grad from the card's vs the CPU's loglikes


class SequenceToy:
    """tests/test_discriminative.py's two-path toy: tid = phone, pdf = tid −
    1; path A emits tid 1 every frame, path B tid 2."""

    @staticmethod
    def tid_to_phone(t):
        return int(t)

    @staticmethod
    def tid_to_pdf(t):
        return int(t) - 1

    @staticmethod
    def lattice(frames):
        from old_kaldi_git_tpu_torch.lat.lattice import Lattice, LatticeArc

        lat = Lattice()
        states_a = [lat.add_state() for _ in range(frames)]
        states_b = [lat.add_state() for _ in range(frames - 1)]
        end = lat.add_state()
        lat.start = states_a[0]
        chain_a, chain_b = states_a + [end], [states_a[0]] + states_b + [end]
        for i in range(frames):
            lat.arcs[chain_a[i]].append(LatticeArc(1, 0, 0.0, 0.0, chain_a[i + 1]))
            lat.arcs[chain_b[i]].append(LatticeArc(2, 0, 0.0, 0.0, chain_b[i + 1]))
        lat.finals[end] = (0.0, 0.0)
        return lat


def sequence_training(torch, np, c) -> dict:
    """The four sequence-training phases on the card; `c` holds main()'s
    objects.  Each path's launch counts are set to 0 just before it and read
    just after; a fault is collected and raised after the four phases.
    Returns {"launches": {path: K1, K2 and K3 counts}, "k1": K1 timed at
    the new paths' shapes, "k3": K3 likewise}."""
    import statistics

    from old_kaldi_git_tpu_torch.chain.e2e import (
        NumeratorGraphBatch, generic_numerator_logprob)
    from old_kaldi_git_tpu_torch.chain.loss import ChainLossOptions, denominator_logprob
    from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch_tokens
    from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel, DiagGmm
    from old_kaldi_git_tpu_torch.gmm.ebw import EbwOptions, ebw_update
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_from_token_records
    from old_kaldi_git_tpu_torch.models import discriminative as disc
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.tdnn import TdnnConfig, TdnnLayerSpec
    from old_kaldi_git_tpu_torch.models.train import NnetTrainOptions, TrainState, make_optimizer
    from old_kaldi_git_tpu_torch.recipes import chain as chain_recipe, mmi, semisup, yesno
    from old_kaldi_git_tpu_torch.recipes.decode import (
        DecodeOptions, decode_dataset, score_hyps)
    from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono
    from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    dev, card, emit = c.dev, c.card, c.emit
    faults, launches = [], {}
    k1_new, k3_new = {}, {}
    ylang = yesno.make_lang()
    fsf = c.chain.model.frame_subsampling_factor
    minilib = c.minilib

    def counted(name, fn):
        """fn() with the counts set to 0 just before and read just after."""
        c.zero_counts()
        c.gmm_loglikes.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = c.read_counts(name)
        got["gmm"] = c.gmm_loglikes.launches
        launches[name] = got
        return out, wall, got

    def median_ms(rep):
        return 1e3 * statistics.median(rep["step_seconds"]) if rep.get("step_seconds") else None

    def rising(objs):
        return len(objs) > 1 and objs[-1] > objs[0]

    def num_le_den(model, graphs, feats, keys):
        """[B] numerators and denominators (leaky 0) of `graphs` on the
        model's logits of `keys`, on the card."""
        padded, nf = chain_recipe.pad_subsampled(feats, keys, model.frame_subsampling_factor)
        with torch.no_grad():
            logits = model.am.logits(padded, output_stride=model.frame_subsampling_factor)
            nft = torch.from_numpy(nf).to(dev)
            num = generic_numerator_logprob(logits, NumeratorGraphBatch.from_csr_graphs(graphs),
                                            nft)
            den = denominator_logprob(logits, nft, model.den, 0.0)
        return num.cpu().numpy(), den.cpu().numpy()

    # ---- train_e2e: flat-start LF-MMI --------------------------------------
    def e2e_yesno():
        tw, tt, sw, st = yesno.make_corpus(24, 8)
        hist, rep = [], {}
        ch = chain_recipe.train_chain_e2e(
            yesno.compute_feats(tw, dev), tt, ylang, chain_recipe.ChainTrainOptions(
                num_epochs=50, minibatch_size=8, hidden_dim=128, bottleneck_dim=32,
                num_layers=3, initial_lr=2e-3, final_lr=2e-4),
            device=dev, history=hist, report=rep)
        graph = chain_recipe.make_chain_decode_graph(
            ch, ylang, make_unigram_grammar_fst(list(tt.values()), ylang.words))
        hyps = chain_recipe.decode_chain(ch, graph, ylang, yesno.compute_feats(sw, dev),
                                         beam=20.0)
        bw, bt, _, _ = yesno.make_corpus(8, 2)
        bhist = []
        chain_recipe.train_chain_e2e(
            yesno.compute_feats(bw, dev), bt, ylang, chain_recipe.ChainTrainOptions(
                num_epochs=8, minibatch_size=8, hidden_dim=64, bottleneck_dim=16,
                num_layers=2, initial_lr=2e-3, final_lr=2e-3, tree_context_width=2),
            device=dev, history=bhist)
        return score_hyps(st, hyps), hist, rep, bhist

    (ystats, yhist, yrep, bhist), ywall, ylaunch = counted("train_e2e_yesno", e2e_yesno)
    yobjs, bobjs = [h["objf"] for h in yhist], [h["objf"] for h in bhist]

    mopts = dataclasses.replace(minilib.chain_train_options(c.topts),
                                num_epochs=E2E_MINILIB_EPOCHS, tree_context_width=1)

    def e2e_minilib():
        feats = minilib.compute_feats({k: c.twaves[k] for k in sorted(c.twaves)[
            :E2E_MINILIB_UTTS]}, device=dev)
        hist, rep = [], {}
        ch = chain_recipe.train_chain_e2e(feats, c.ttext, c.lang, mopts, device=dev,
                                          history=hist, report=rep)
        return feats, ch, hist, rep

    (mfeats, mch, mhist, mrep), mwall, mlaunch = counted("train_e2e_minilib", e2e_minilib)
    mobjs = [h["objf"] for h in mhist]
    # one step from the same initial network and batch (the 8 first
    # utterances by name) on both devices: the losses
    skeys = sorted(mfeats)[:8]
    sgraphs = NumeratorGraphBatch.from_csr_graphs(chain_recipe.numerator_graphs(
        c.lang, mch.ctx_dep, mch.tm, mch.den, [c.ttext[k] for k in skeys]))
    sbf, snf = chain_recipe.pad_subsampled(mfeats, skeys, fsf)
    step_loss = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        am0 = AmNnet.init(mch.am.config, seed=mopts.seed, device=where)
        opt = make_optimizer(NnetTrainOptions(initial_lr=mopts.initial_lr,
                                              final_lr=mopts.final_lr), 10)
        step = chain_recipe.make_chain_e2e_step(
            am0.model.train(), mch.den, opt, ChainLossOptions(
                leaky_hmm_coefficient=mopts.leaky_hmm_coefficient,
                l2_regularize=mopts.l2_regularize, xent_regularize=0.0), fsf)
        _, loss, _ = step(TrainState(opt.init(dict(am0.model.named_parameters())), 0), sbf,
                          snf, sgraphs)
        step_loss[name] = float(loss)
    step_rel = abs(step_loss["card"] - step_loss["cpu"]) / abs(step_loss["cpu"])
    emit({"phase": "train_e2e", "card": card,
          "yesno": {"utterances": [24, 8], "epochs": len(yhist), "objf_by_epoch": yobjs,
                    "wer_percent": ystats.wer, "errors": ystats.errors,
                    "ref_words": ystats.ref_len, "num_states": yrep["num_states"],
                    "num_arcs": yrep["num_arcs"], "den_states": yrep["den_states"],
                    "step_ms_median": median_ms(yrep), "steps": yrep["steps"],
                    "biphone_objf_by_epoch": bobjs, "wall_seconds": ywall,
                    "gather_launches": ylaunch["gather"], "mfcc_launches": ylaunch["mfcc"]},
          "minilib": {"utterances": len(mfeats), "tree_pdfs": mrep["tree_pdfs"],
                      "model": f"TDNN-F 39 -> {mopts.hidden_dim} (bottleneck "
                               f"{mopts.bottleneck_dim}) x {mopts.num_layers}",
                      "den_states": mrep["den_states"], "num_states": mrep["num_states"],
                      "num_arcs": mrep["num_arcs"], "epochs": len(mhist),
                      "objf_by_epoch": mobjs, "steps": mrep["steps"],
                      "step_ms_median": median_ms(mrep),
                      "objects_seconds": mrep["objects_seconds"],
                      "numerator_seconds": mrep["numerator_seconds"],
                      "train_seconds": mrep["train_seconds"], "wall_seconds": mwall,
                      "one_step_loss": step_loss, "one_step_rel_diff": step_rel,
                      "mfcc_launches": mlaunch["mfcc"]}})
    if not (ystats.wer <= 2.0 and yobjs and all(o <= 1e-6 for o in yobjs)):
        faults.append(f"train_e2e yesno: WER {ystats.wer}, objf {yobjs}")
    if not (bobjs and all(o <= 1e-6 for o in bobjs) and rising(bobjs)):
        faults.append(f"train_e2e yesno biphone: objf {bobjs}")
    if not (mobjs and all(o <= 1e-6 for o in mobjs) and rising(mobjs)):
        faults.append(f"train_e2e minilib: objf {mobjs}")
    if not step_rel <= NNET_STEP_TOL:
        faults.append(f"train_e2e minilib: one step's loss card vs CPU {step_loss}")
    if min(ylaunch["mfcc"], mlaunch["mfcc"]) == 0:
        faults.append(f"train_e2e did not go through K2: {ylaunch}, {mlaunch}")
    del mch
    torch.cuda.empty_cache()

    # ---- train_semisup: lattice-supervised LF-MMI --------------------------
    def semisup_yesno():
        runs = []
        for init in SEMISUP_YESNO_INITS:
            tw, tt, sw, st = yesno.make_corpus(24, 6)
            keys = sorted(tt)
            sup, unsup = keys[:12], keys[12:]
            feats = yesno.compute_feats(tw, dev)
            test = yesno.compute_feats(sw, dev)
            seed = chain_recipe.train_chain_e2e(
                {k: feats[k] for k in sup}, {k: tt[k] for k in sup}, ylang,
                chain_recipe.ChainTrainOptions(num_epochs=30, minibatch_size=8, hidden_dim=128,
                                               bottleneck_dim=32, num_layers=3,
                                               initial_lr=2e-3, final_lr=4e-4, seed=init),
                device=dev)
            graph = chain_recipe.make_chain_decode_graph(
                seed, ylang, make_unigram_grammar_fst(list(tt.values()), ylang.words))
            seed_wer = score_hyps(st, chain_recipe.decode_chain(seed, graph, ylang, test,
                                                                beam=20.0)).wer
            sopts = semisup.SemisupOptions(num_epochs=6, minibatch_size=8, initial_lr=3e-4,
                                           final_lr=1e-4, lattice_lm_scale=0.5,
                                           unsup_egs_weight=1.0)
            ufeats = {k: feats[k] for k in unsup}
            lats = semisup.decode_chain_lattices(seed, graph, ufeats, beam=sopts.beam,
                                                 max_active=sopts.max_active,
                                                 lattice_beam=sopts.lattice_beam)
            ukeys, ugraphs = semisup.lattice_numerators(seed, lats, sopts)
            num, den = num_le_den(seed, ugraphs, ufeats, ukeys)
            hist = []
            model = semisup.train_chain_semisup(
                seed, ylang, {k: feats[k] for k in sup}, {k: tt[k] for k in sup}, ufeats,
                graph, sopts, history=hist)
            wer = score_hyps(st, chain_recipe.decode_chain(model, graph, ylang, test,
                                                           beam=20.0)).wer
            runs.append({"init": init, "seed_wer_percent": seed_wer, "wer_percent": wer,
                         "lattice_numerators": len(ugraphs),
                         "num_minus_den_max": float((num - den).max()),
                         "objf_by_epoch": [h["objf"] for h in hist]})
        return runs

    yruns, yswall, yslaunch = counted("train_semisup_yesno", semisup_yesno)
    gated = yruns[0]

    cm = c.chain.model
    ss_opts = semisup.SemisupOptions(num_epochs=1)
    ss_keys = sorted(c.twaves)[: 2 * SEQ_UTTS]
    ss_sup, ss_unsup = ss_keys[:SEQ_UTTS], ss_keys[SEQ_UTTS:]

    def semisup_minilib():
        feats = minilib.compute_feats({k: c.twaves[k] for k in ss_keys}, device=dev)
        tim = {}
        t0 = time.perf_counter()
        padded, nf = chain_recipe.pad_subsampled(feats, ss_unsup, fsf)
        res = decode_batch_tokens(
            c.chain.csr, cm.am.logits(padded, output_stride=fsf), nf,
            ViterbiOptions(beam=BEAM, max_active=CHAIN_MAX_ACTIVE, acoustic_scale=1.0),
            want_lattice=True, lattice_beam=ss_opts.lattice_beam, device=dev)
        torch.cuda.synchronize()
        tim["decode_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lats = {k: lattice_from_token_records(c.chain.csr, r.token_lattice)
                for k, r in zip(ss_unsup, res) if r is not None and r.token_lattice is not None}
        lats = {k: v for k, v in lats.items() if v is not None}
        tim["lattice_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ukeys, ugraphs = semisup.lattice_numerators(cm, lats, ss_opts)
        sgraphs = chain_recipe.numerator_graphs(c.lang, cm.ctx_dep, cm.tm, cm.den,
                                                [c.ttext[k] for k in ss_sup])
        tim["numerator_seconds"] = time.perf_counter() - t0
        num, den = num_le_den(cm, ugraphs, feats, ukeys)
        hist, rep = [], {}
        t0 = time.perf_counter()
        weights = np.concatenate([np.ones(len(ss_sup), np.float32),
                                  np.full(len(ukeys), ss_opts.unsup_egs_weight, np.float32)])
        semisup.train_on_numerators(cm, feats, ss_sup + ukeys, sgraphs + ugraphs, weights,
                                    ss_opts, history=hist, report=rep)
        torch.cuda.synchronize()
        tim["train_seconds"] = time.perf_counter() - t0
        return lats, ugraphs, sgraphs, num, den, hist, rep, tim

    (slats, ugr, sgr, snum, sden, shist, srep, stim), sswall, sslaunch = counted(
        "train_semisup_minilib", semisup_minilib)
    sobjs = [o for h in shist for o in h["step_objf"]]
    emit({"phase": "train_semisup", "card": card,
          "yesno": {"flow": "12 supervised + 12 unsupervised, 30-epoch e2e seed, "
                            "6 semisup epochs, 6 test utterances",
                    "gated_run": gated, "other_inits": yruns[1:],
                    "seed_wer_mean": float(np.mean([r["seed_wer_percent"] for r in yruns])),
                    "wer_mean": float(np.mean([r["wer_percent"] for r in yruns])),
                    "wall_seconds": yswall, "gather_launches": yslaunch["gather"],
                    "mfcc_launches": yslaunch["mfcc"]},
          "minilib": {"model": "exp/minilib/chain.mdl", "pdfs": cm.am.config.num_outputs,
                      "den_states": cm.den.num_states, "supervised": len(ss_sup),
                      "lattices": len(slats), "lattice_supervised": len(ugr),
                      "lattice_route": "decode_batch_tokens lattice records on "
                                       "chain_hclg.npz, lattice_from_token_records",
                      "lattice_arcs": sum(v.num_arcs for v in slats.values()),
                      "num_states": max(g.num_states for g in ugr + sgr),
                      "num_arcs": max(g.num_arcs for g in ugr + sgr),
                      "lattice_num_states": max(g.num_states for g in ugr),
                      "num_minus_den_max": float((snum - sden).max()),
                      "objf_by_step": sobjs, "steps": srep.get("steps"),
                      "step_ms_median": median_ms(srep), **stim, "wall_seconds": sswall,
                      "gather_launches": sslaunch["gather"],
                      "mfcc_launches": sslaunch["mfcc"]}})
    if not gated["wer_percent"] <= max(gated["seed_wer_percent"], 15.0):
        faults.append(f"train_semisup yesno: WER {gated['wer_percent']}, the seed's "
                      f"{gated['seed_wer_percent']}")
    for r in yruns:
        if not (r["num_minus_den_max"] <= NUM_LE_DEN_TOL and r["objf_by_epoch"] and all(
                np.isfinite(o) and o <= 1e-6 for o in r["objf_by_epoch"])):
            faults.append(f"train_semisup yesno init {r['init']}: {r}")
    if not (float((snum - sden).max()) <= NUM_LE_DEN_TOL and sobjs
            and all(np.isfinite(o) and o <= 1e-6 for o in sobjs)):
        faults.append(f"train_semisup minilib: num - den {float((snum - sden).max())}, "
                      f"objf {sobjs}")
    if min(yslaunch["mfcc"], sslaunch["mfcc"], sslaunch["gather"]) == 0:
        faults.append(f"train_semisup did not go through K1/K2: {yslaunch}, {sslaunch}")
    if len(ugr) < SEQ_UTTS // 2:
        faults.append(f"train_semisup minilib: {len(ugr)} lattice numerators of {SEQ_UTTS}")

    # ---- train_mmi: MMI of GMMs by EBW --------------------------------------
    def on_cpu(model):
        return AmGmmModel(model.tm, AmDiagGmm([DiagGmm(p.weights.copy(), p.means.copy(),
                                                       p.vars.copy()) for p in model.am.pdfs],
                                              device="cpu"))

    def ebw_on_cpu(model0, feats, alignments, hist0, acoustic_scale, tau):
        """Iteration 0's statistics and EBW update redone on the CPU from the
        lattices the card decoded: (num frames, den frames, updated,
        skipped, the CPU model)."""
        cpu = on_cpu(model0)
        keys = [k for k, a in alignments.items() if a is not None and k in feats]
        num = mmi.accumulate_num_stats(cpu, feats, alignments, keys)
        den = mmi.accumulate_den_stats_from_lattices(cpu, hist0["lattice_dict"], feats,
                                                     acoustic_scale)
        counts = ebw_update(cpu.am, num, den, EbwOptions(tau=tau))
        return num.tot_frames, den.tot_frames, counts[0], counts[1], cpu

    def mmi_check(name, means, cpu_out, hist0):
        """Iteration 0 on the card (its history and the means after it)
        against the CPU's redo."""
        nf_c, df_c, up_c, sk_c, cpu = cpu_out
        mean_diff = max(float(np.abs(m - q.means).max()) for m, q in zip(means, cpu.am.pdfs))
        same = (hist0["num_frames"] == nf_c and abs(hist0["den_frames"] - df_c) <= 1e-6 * df_c
                and (hist0["updated"], hist0["skipped"]) == (up_c, sk_c))
        if not (same and mean_diff <= EBW_MEAN_TOL):
            faults.append(f"{name}: card {hist0['num_frames']}, {hist0['den_frames']}, "
                          f"{hist0['updated']}/{hist0['skipped']}; CPU {nf_c}, {df_c}, "
                          f"{up_c}/{sk_c}; means apart by {mean_diff}")
        return {"num_frames": hist0["num_frames"], "den_frames": hist0["den_frames"],
                "updated": hist0["updated"], "skipped": hist0["skipped"],
                "cpu": {"num_frames": nf_c, "den_frames": df_c, "updated": up_c,
                        "skipped": sk_c}, "means_max_abs_diff": mean_diff}

    def mmi_yesno():
        tw, tt, sw, st = yesno.make_corpus(24, 8)
        tf, sf = yesno.compute_feats(tw, dev), yesno.compute_feats(sw, dev)
        model, ali = train_mono(tf, tt, ylang, MonoTrainOptions(num_iters=10, totgauss=80),
                                device=dev)
        phones = ylang.real_phone_ids
        topo = model.tm.topo
        cd = monophone_context_dependency(phones, {p: topo.num_pdf_classes(p)
                                                   for p in phones})
        csr = mkgraph_csr(ylang, make_unigram_grammar_fst(list(tt.values()), ylang.words), cd,
                          model.tm)
        opts = mmi.MmiTrainOptions(num_iters=1, acoustic_scale=0.2, beam=20.0, tau=20.0)
        model0 = on_cpu(model)
        hist = []
        mmi.train_mmi(model, csr, ylang, tf, ali, opts, history=hist)  # iteration 0
        means0 = [p.means.copy() for p in model.am.pdfs]
        cpu_out = ebw_on_cpu(model0, tf, ali, hist[0], 0.2, 20.0)
        mmi.train_mmi(model, csr, ylang, tf, ali, opts, history=hist)  # iteration 1
        hist[1]["iter"] = 1
        hyps = decode_dataset(model, csr, ylang, sf, DecodeOptions(beam=20.0,
                                                                   acoustic_scale=0.2))
        return model, hist, means0, cpu_out, score_hyps(st, hyps), tf

    (ymodel, ymhist, ymeans0, ycpu, ymstats, ytf), ymwall, ymlaunch = counted(
        "train_mmi_yesno", mmi_yesno)
    y_check = mmi_check("train_mmi yesno", ymeans0, ycpu, ymhist[0])
    tri_ali = c.convert.load_pickle("exp/minilib/tri_ali.pkl")
    mkeys = [k for k in sorted(c.twaves) if tri_ali.get(k) is not None][:SEQ_UTTS]
    mopts_mmi = mmi.MmiTrainOptions(num_iters=1)

    def mmi_minilib():
        feats = minilib.compute_feats({k: c.twaves[k] for k in mkeys}, device=dev)
        tri = AmGmmModel.load("exp/minilib/tri.mdl", device=dev)
        model0 = on_cpu(tri)
        hist = []
        mmi.train_mmi(tri, c.system.csr, c.system.words, feats,
                      {k: tri_ali[k] for k in mkeys}, mopts_mmi, history=hist)
        return tri, hist, model0, feats

    (mtri, mmhist, mmodel0, mmfeats), mmwall, mmlaunch = counted("train_mmi_minilib",
                                                                 mmi_minilib)
    tri_pdfs = mtri.am.num_pdfs
    m_check = mmi_check("train_mmi minilib", [p.means for p in mtri.am.pdfs], ebw_on_cpu(
        mmodel0, mmfeats, {k: tri_ali[k] for k in mkeys}, mmhist[0],
        mopts_mmi.acoustic_scale, mopts_mmi.tau), mmhist[0])
    # K3 on the updated models (their rows packed anew after EBW) against its
    # plain version, timed at the minilib shape
    plug = c.plug
    ybatch = torch.from_numpy(np.concatenate([ytf[k] for k in sorted(ytf)])).to(dev)
    mbatch = torch.from_numpy(np.concatenate([mmfeats[k] for k in mkeys])).to(dev)
    k3_new["train_mmi_yesno"] = k3_at(torch, c.gmm_loglikes, c.gmm_loglikes_plain,
                                       ymodel.am.weights(), ybatch, plug)
    k3_new["train_mmi_minilib"] = k3_at(torch, c.gmm_loglikes, c.gmm_loglikes_plain,
                                         mtri.am.weights(), mbatch, plug)
    emit({"phase": "train_mmi", "card": card,
          "yesno": {"gaussians": ymodel.am.num_gauss, "iterations": len(ymhist),
                    "acoustic_scale": 0.2, "tau": 20.0,
                    "by_iteration": [{k: v for k, v in h.items() if k != "lattice_dict"}
                                     for h in ymhist],
                    "iteration_0_card_vs_cpu": y_check, "wer_percent": ymstats.wer,
                    "errors": ymstats.errors, "wall_seconds": ymwall,
                    "gather_launches": ymlaunch["gather"], "mfcc_launches": ymlaunch["mfcc"],
                    "gmm_launches": ymlaunch["gmm"]},
          "minilib": {"model": "exp/minilib/tri.mdl", "graph": "exp/minilib/hclg.npz",
                      "utterances": len(mkeys), "gaussians": mtri.am.num_gauss,
                      "options": dataclasses.asdict(mopts_mmi),
                      "lattice_arcs": sum(v.num_arcs
                                          for v in mmhist[0]["lattice_dict"].values()),
                      "iteration_0_card_vs_cpu": m_check, "wall_seconds": mmwall,
                      "gather_launches": mmlaunch["gather"], "mfcc_launches": mmlaunch["mfcc"],
                      "gmm_launches": mmlaunch["gmm"]},
          "gmm_kernel_after_ebw": {k: {"max_abs_err": v["max_abs_err"],
                                       "worst_share_of_tolerance": v["worst_share_of_tolerance"],
                                       "kernel_ms": v["kernel_ms"]} for k, v in k3_new.items()}})
    if ymstats.wer != 0.0:
        faults.append(f"train_mmi yesno: WER {ymstats.wer}")
    if min(ymlaunch["gmm"], ymlaunch["gather"], ymlaunch["mfcc"], mmlaunch["gmm"],
           mmlaunch["gather"], mmlaunch["mfcc"]) == 0:
        faults.append(f"train_mmi did not go through K1/K2/K3: {ymlaunch}, {mmlaunch}")
    del mtri, mmodel0, ymodel, ybatch, mbatch, ymhist, mmhist
    torch.cuda.empty_cache()

    # ---- train_discriminative: nnet3 MMI / sMBR ------------------------------
    def disc_toy():
        rng = np.random.default_rng(1)
        T = 12
        feats = {f"u{u}": rng.normal(size=(T, 6)).astype(np.float32) + 0.5 for u in range(8)}
        alis = {k: np.full(T, 1, np.int32) for k in feats}
        lats = {k: SequenceToy.lattice(T) for k in feats}
        out = {}
        for crit in ("smbr", "mmi"):
            am = AmNnet.init(TdnnConfig(6, 2, (TdnnLayerSpec("tdnn", 16, (-1, 0, 1)),)),
                             seed=0, device=dev, log_priors=np.log(np.full(2, 0.5)))
            opts = disc.DiscriminativeOptions(criterion=crit, num_epochs=4, minibatch_size=4,
                                              learning_rate=0.05, acoustic_scale=1.0)
            before = disc.compute_discriminative_objf(am, feats, alis, lats, SequenceToy, opts)
            am2 = disc.train_discriminative(am, feats, alis, lats, SequenceToy, opts)
            out[crit] = {"before": before, "after": disc.compute_discriminative_objf(
                am2, feats, alis, lats, SequenceToy, opts)}
        return out

    toy_objf, _, _ = counted("train_discriminative_toy", disc_toy)
    dopts = disc.DiscriminativeOptions(num_epochs=1)
    dkeys = mkeys
    tri_tm = AmGmmModel.load("exp/minilib/tri.mdl", device="cpu").tm

    def disc_minilib():
        feats = minilib.compute_feats({k: c.twaves[k] for k in dkeys}, device=dev)
        am = c.system.am
        tim = {}
        t0 = time.perf_counter()
        lats = {}
        by_dur = sorted(dkeys, key=lambda k: feats[k].shape[0])
        vopts = ViterbiOptions(beam=BEAM, max_active=RESCORE_MAX_ACTIVE,
                               acoustic_scale=1.0)
        for lo in range(0, len(by_dur), RESCORE_BATCH):
            keys, padded, nf = pad_feature_batch({k: feats[k] for k in
                                                  by_dur[lo: lo + RESCORE_BATCH]})
            res = decode_batch_tokens(c.system.csr, am.loglikes_batch(padded), nf, vopts,
                                      want_lattice=True, lattice_beam=8.0, device=dev)
            for k, r in zip(keys, res):
                lat = (None if r is None or r.token_lattice is None
                       else lattice_from_token_records(c.system.csr, r.token_lattice))
                if lat is not None:
                    lats[k] = lat
        torch.cuda.synchronize()
        tim["lattice_seconds"] = time.perf_counter() - t0
        ali = {k: tri_ali[k] for k in lats}
        t0 = time.perf_counter()
        before = disc.compute_discriminative_objf(am, feats, ali, lats, tri_tm, dopts)
        tim["objf_seconds"] = time.perf_counter() - t0
        hist = []
        t0 = time.perf_counter()
        am2 = disc.train_discriminative(am, feats, ali, lats, tri_tm, dopts, history=hist)
        torch.cuda.synchronize()
        tim["train_seconds"] = time.perf_counter() - t0
        after = disc.compute_discriminative_objf(am2, feats, ali, lats, tri_tm, dopts)
        return feats, lats, before, after, hist, tim

    (dfeats, dlats, dbefore, dafter, dhist, dtim), dwall, dlaunch = counted(
        "train_discriminative_minilib", disc_minilib)
    # discriminative_grad from the card's loglikes against the CPU's (final.am
    # on the CPU, the same features and lattices), on 4 utterances
    cpu_am = AmNnet.load(os.path.join(c.system.workdir, "final.am"), device="cpu")
    grad_diff = 0.0
    for k in sorted(dlats)[:4]:
        x = np.asarray(dfeats[k], np.float32)[None]
        gk, ok = disc.discriminative_grad(tri_tm, c.system.am.loglikes_batch(x)[0].cpu().numpy(),
                                          tri_ali[k], copy.deepcopy(dlats[k]))
        gc, oc = disc.discriminative_grad(tri_tm, cpu_am.loglikes_batch(x)[0].numpy(),
                                          tri_ali[k], copy.deepcopy(dlats[k]))
        grad_diff = max(grad_diff, float(np.abs(gk - gc).max()), abs(ok - oc))
    emit({"phase": "train_discriminative", "card": card,
          "toy": {"flow": "tests/test_discriminative.py two-path toy, 4 epochs",
                  "objf": toy_objf},
          "minilib": {"model": "exp/minilib/final.am", "criterion": dopts.criterion,
                      "learning_rate": dopts.learning_rate, "acoustic_scale":
                      dopts.acoustic_scale, "epochs": dopts.num_epochs,
                      "utterances": len(dkeys), "lattices": len(dlats),
                      "lattice_arcs": sum(v.num_arcs for v in dlats.values()),
                      "objf_before": dbefore, "objf_after": dafter,
                      "objf_by_epoch": [h["objf"] for h in dhist], **dtim,
                      "wall_seconds": dwall, "grad_card_vs_cpu_max_abs": grad_diff,
                      "gather_launches": dlaunch["gather"], "mfcc_launches": dlaunch["mfcc"]}})
    for crit, v in toy_objf.items():
        if not v["after"] > v["before"] + 1e-3:
            faults.append(f"train_discriminative toy {crit}: {v}")
    if not grad_diff <= DISC_GRAD_TOL:
        faults.append(f"train_discriminative: grad card vs CPU {grad_diff}")
    if not (np.isfinite(dbefore) and np.isfinite(dafter) and len(dlats) >= SEQ_UTTS // 2):
        faults.append(f"train_discriminative minilib: objf {dbefore} -> {dafter}, "
                      f"{len(dlats)} lattices")
    if min(dlaunch["gather"], dlaunch["mfcc"]) == 0:
        faults.append(f"train_discriminative did not go through K1/K2: {dlaunch}")
    # K1 at the MMI lattice decode's shape: tri.mdl's pdfs, the 64
    # utterances in one batch, K = DecodeOptions().max_active
    k1_new["train_mmi_minilib"] = c.gather_at(SEQ_UTTS, tri_pdfs, c.token_budget(
        DecodeOptions().max_active), 768)
    torch.cuda.empty_cache()
    if faults:
        raise RuntimeError("sequence training: " + "; ".join(faults))
    return {"launches": launches, "k1": k1_new, "k3": k3_new}


LATTICE_UTTS = 64  # held-out utterances at NOISE_EVAL of the lattice_outputs phase
LATTICE_BEAM = 10.0  # decode_dataset_with_lattices' default
LATTICE_DET_UTTS = 8  # of the 64: decoded once more with determinize=True
RNNLM_SENTENCES = 10_000  # the first of the 4-gram's own LM text (cut from 20,000)
RNNLM_HELD_OUT = 256  # sentences scored on the card and on the CPU
RNNLM_SCORE_TOL = 1e-3  # nats a sentence, card vs CPU
RNNLM_STEP_TOL = 1e-5  # one step's loss, card vs CPU, relative
NBEST = 10
POST_SUM_TOL = 1e-4


def lattice_outputs(torch, np, c) -> dict:
    """The lattice_outputs phase: what users read from a decode, on the card.
    64 held-out utterances at noise 400, features through K2, tri.mdl's
    loglikes through K3, recipes/decode.decode_dataset_with_lattices at
    DecodeOptions() on hclg.npz with lattice records through K1, its
    lattices determinized by the native library of cpp/lattice.cc and by
    the Python algorithm, which must agree, and the first 8 decoded once
    more with determinize=True, whose lattices must equal the native ones;
    each lattice's best path held to the decoder's words; the LM-weight sweep, MBR, CTM with confidences, frame
    posteriors, a compact-lattice archive written ark,scp: and read back;
    decode_biglm with the identity and from the pruned trigram to the
    rescore phase's 4-gram; the RNNLM at RnnLmOptions() over the 20k-word
    vocabulary trained one epoch on the card, held to the CPU, and its
    n-best rescoring.  K1, K2 and K3 are counted over the whole phase.
    Returns {"launches", "k1", "k3", "faults", "lattices"} (the 64 raw
    lattices, which the cli_kws phase searches)."""
    import statistics

    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_phones
    from old_kaldi_git_tpu_torch.lat import ctm as lat_ctm, mbr as lat_mbr
    from old_kaldi_git_tpu_torch.lat.determinize import determinize_lattice_pruned
    from old_kaldi_git_tpu_torch.lat.lattice import (
        lattice_best_path, lattice_nbest_paths, lattice_to_post)
    from old_kaldi_git_tpu_torch.lm import rnnlm as lm_rnn
    from old_kaldi_git_tpu_torch.recipes import decode
    from old_kaldi_git_tpu_torch.utils.log import KaldiError
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

    dev, card, emit, minilib = c.dev, c.card, c.emit, c.minilib
    faults, stages = [], {}
    words = c.system.words
    opts = minilib.MinilibOptions()
    dopts = decode.DecodeOptions()
    acs = dopts.acoustic_scale

    def clat_tuple(clat):
        return (clat.num_states, clat.start, list(clat.finals),
                [[(a.word, tuple(a.tids), a.graph_cost, a.acoustic_cost, a.nextstate)
                  for a in lst] for lst in clat.arcs])

    def wer_of(hyps):
        return c.compute_wer(ref, {k: list(hyps.get(k, [])) for k in ref}).wer

    def lap(name, t0):
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return time.perf_counter()

    c.zero_counts()
    c.gmm_loglikes.launches = 0
    t_phase = t0 = time.perf_counter()
    waves, text = minilib.make_test_set(opts, noise=minilib.NOISE_EVAL)
    keys = sorted(waves)[:LATTICE_UTTS]
    ref = {k: list(text[k]) for k in keys}
    gmm = AmGmmModel.load("exp/minilib/tri.mdl", device=dev)
    t0 = lap("setup_seconds", t0)
    feats = minilib.compute_feats({k: waves[k] for k in keys}, device=dev)
    t0 = lap("features_seconds", t0)
    decoded, d1 = {}, {}
    raw = decode.decode_dataset_with_lattices(gmm, c.system.csr, words, feats, dopts,
                                              LATTICE_BEAM, timings=d1, decoder_words=decoded)
    t0 = lap("decode_seconds", t0)
    # the native determinization of the 64 lattices, as the decode's
    # determinize=True runs it; the determinized decode itself on the first
    # LATTICE_DET_UTTS only (cut from 64 for time, PERF.md §4), whose
    # lattices must equal those
    clats = {k: determinize_lattice_pruned(lat, LATTICE_BEAM, acoustic_scale=acs)
             for k, lat in raw.items()}
    t0 = lap("determinize_native_seconds", t0)
    d2 = {}
    det_keys = keys[:LATTICE_DET_UTTS]
    dclats = decode.decode_dataset_with_lattices(gmm, c.system.csr, words,
                                                 {k: feats[k] for k in det_keys}, dopts,
                                                 LATTICE_BEAM, determinize=True, timings=d2)
    decode_det_differ = [k for k in det_keys if k not in dclats
                         or clat_tuple(dclats[k]) != clat_tuple(clats[k])]
    del dclats
    t0 = lap("decode_determinized_seconds", t0)
    py_clats = {k: determinize_lattice_pruned(lat, LATTICE_BEAM, acoustic_scale=acs,
                                              algorithm="python") for k, lat in raw.items()}
    t0 = lap("determinize_python_seconds", t0)
    det_differ = [k for k in keys if k not in clats or k not in py_clats
                  or clat_tuple(clats[k]) != clat_tuple(py_clats[k])]
    best_differ = [k for k in keys if k not in raw
                   or lattice_best_path(raw[k], 1.0, acs)[0] != decoded.get(k)]
    map_hyps = {k: [words[w] for w in decoded.get(k, [])] for k in keys}
    map_wer = wer_of(map_hyps)
    del py_clats
    # the LM-weight sweep over the raw lattices (score.sh's LMWT loop)
    sweep = {}
    best_scale, best_stats = decode.score_lattices_sweep(raw, words, ref, acs, report=sweep)
    t0 = lap("sweep_seconds", t0)
    # MBR on the determinized lattices
    mbr_hyps, exp_wer, mbr_bad = {}, [], []
    for k in keys:
        res = lat_mbr.minimum_bayes_risk(clats[k], 1.0, acs) if k in clats else None
        if res is None:
            mbr_bad.append(k)
            continue
        mbr_hyps[k] = [words[w] for w in res.words]
        exp_wer.append(res.expected_wer)
        if not (all(0.0 <= x <= 1.0 for x in res.confidences)
                and all(abs(sum(p for _, p in b) - 1.0) <= POST_SUM_TOL for b in res.sausage)):
            mbr_bad.append(k)
    t0 = lap("mbr_seconds", t0)
    # CTM with confidences from the raw lattices.  A search that ends off
    # the graph's final states (the noisy set, DecodeOptions()) leaves its
    # last word's phones unfinished, and the lexicon walk of
    # align_words_lexicon refuses it (KaldiError, as the JAX package's
    # does): such an utterance is counted, after checking that its phones
    # are a strict prefix of its words' pronunciations
    prons = {w: [c.lang.phones[p] for p in pron] for w, _, pron in c.lang.lexicon.entries}
    sil = c.lang.silence_id
    ctm_lines, ctm_bad, ctm_ends_inside_a_word = 0, [], []
    for k in keys:
        best, tids, _ = lattice_best_path(raw[k], 1.0, acs)
        try:
            entries = lat_ctm.lattice_to_ctm_conf(raw[k], gmm.tm, c.lang, k, 1.0, acs)
        except KaldiError:
            phones = [p for p in alignment_to_phones(gmm.tm, tids) if p != sil]
            want = [p for w in best for p in prons[words[w]]]
            if len(phones) < len(want) and want[: len(phones)] == phones:
                ctm_ends_inside_a_word.append(k)
            else:
                ctm_bad.append(k)
            continue
        ctm_lines += len(entries)
        starts = [e.start for e in entries]
        if (len(entries) != len(best) or not all(0.0 <= e.confidence <= 1.0 for e in entries)
                or starts != sorted(starts)):
            ctm_bad.append(k)
    t0 = lap("ctm_seconds", t0)
    post_err = 0.0
    for k in keys:
        post = lattice_to_post(raw[k], gmm.tm, 1.0, acs, min_post=0.0)
        post_err = max([post_err] + [abs(sum(w for _, w in f) - 1.0) for f in post])
    t0 = lap("post_seconds", t0)
    # a compact-lattice archive and its script, read back: the holder keeps
    # each weight's %.6g text, so the read lattices equal the written ones
    # to those digits and exactly in everything else
    tmp = tempfile.mkdtemp(dir=os.getcwd())
    try:
        with TableWriter(f"ark,scp:{tmp}/lat.ark,{tmp}/lat.scp", "clat") as w:
            for k in keys:
                w[k] = clats[k]
        back = read_table(f"scp:{tmp}/lat.scp", "clat")
        ark_bytes = os.path.getsize(f"{tmp}/lat.ark")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r6 = lambda x: float(f"{x:.6g}") if x != np.inf else x  # noqa: E731

    def rounded(clat):
        n, s, fin, arcs = clat_tuple(clat)
        return (n, s, [(r6(g), r6(a), t) for g, a, t in fin],
                [[(wd, t, r6(g), r6(a), ns) for wd, t, g, a, ns in lst] for lst in arcs])
    archive_differ = [k for k in keys if k not in back or rounded(back[k]) != rounded(clats[k])]
    t0 = lap("archive_seconds", t0)
    # decode_biglm on the determinized lattices: the identity, then the 4-gram
    pruned, full = c.rescore_lms["pruned"], c.rescore_lms["full"]
    same = decode.decode_biglm(gmm, c.system.csr, words, feats, pruned, pruned, dopts,
                               lattices=clats)
    identity_differ = [k for k in keys if same.get(k) != [
        words[w] for w in clats[k].best_path(1.0, acs)[0]]]
    t0 = lap("biglm_identity_seconds", t0)
    big = decode.decode_biglm(gmm, c.system.csr, words, feats, pruned, full, dopts,
                              lattices=clats)
    big_wer = wer_of(big)
    t0 = lap("biglm_4gram_seconds", t0)
    counts = c.read_counts("lattice_outputs")
    counts["gmm"] = c.gmm_loglikes.launches
    # the RNNLM: trained on the card at its own full width, held to the CPU
    sents = minilib.make_text(opts, opts.lm_sentences, opts.seed + 2)
    train = [[int(w) + 1 for w in s] for s in sents[:RNNLM_SENTENCES]]  # word-table ids
    held = [[int(w) + 1 for w in s] for s in sents[-RNNLM_HELD_OUT:]]
    del sents
    t0 = lap("rnnlm_text_seconds", t0)
    ropts = lm_rnn.RnnLmOptions(num_epochs=1)
    torch.cuda.reset_peak_memory_stats()
    hist = []
    rlm = lm_rnn.train_rnnlm(train, opts.num_words, ropts, device=dev, history=hist)
    t0 = lap("rnnlm_train_seconds", t0)
    rnn_peak = torch.cuda.max_memory_allocated()
    losses = hist[0]["losses"]
    cpu_lm = lm_rnn.RnnLm(copy.deepcopy(rlm.model).to("cpu"), rlm.opts, rlm.vocab)
    score_diff = float(np.abs(rlm.logprobs_batch(held) - cpu_lm.logprobs_batch(held)).max())
    step = {}
    for where, lm in (("card", rlm), ("cpu", cpu_lm)):
        h = []
        lm_rnn.train_rnnlm(train[:ropts.batch_size], opts.num_words, ropts,
                           device=lm.device, init=lm, history=h)
        step[where] = h[0]["losses"][0]
    step_rel = abs(step["card"] - step["cpu"]) / abs(step["cpu"])
    del cpu_lm
    t0 = lap("rnnlm_cpu_check_seconds", t0)
    rnn_hyps = {}
    for k in keys:
        nb = [([a.olabel for a in arcs if a.olabel],
               sum(a.graph_cost + acs * a.acoustic_cost for a in arcs) + fin[0] + acs * fin[1])
              for arcs, fin in lattice_nbest_paths(raw[k], NBEST, 1.0, acs)]
        resc = lm_rnn.rescore_nbest_rnnlm(
            nb, rlm, lambda ws: -pruned.score_sequence([words[w] for w in ws]))
        rnn_hyps[k] = [words[w] for w in resc[0][0]] if resc else []
    rnn_wer = wer_of(rnn_hyps)
    t0 = lap("rnnlm_rescore_seconds", t0)
    wall = time.perf_counter() - t_phase
    emit({"phase": "lattice_outputs", "card": card, "model": "exp/minilib/tri.mdl",
          "graph": "exp/minilib/hclg.npz", "utterances": len(keys),
          "noise": minilib.NOISE_EVAL, "beam": dopts.beam, "max_active": dopts.max_active,
          "acoustic_scale": acs, "lattice_beam": LATTICE_BEAM,
          "lattices": len(raw), "lattice_arcs": sum(x.num_arcs for x in raw.values()),
          "compact_lattice_arcs": sum(x.num_arcs for x in clats.values()),
          "determinized_decode_utterances": len(det_keys),
          "determinized_decode_differs_from_native": decode_det_differ,
          "native_equals_python": len(keys) - len(det_differ),
          "native_differs_from_python": det_differ,
          "best_path_equals_decoder": len(keys) - len(best_differ),
          "best_path_differs_from_decoder": best_differ,
          "wer_map": map_wer, "sweep_wer_by_lm_scale": {str(s): w for s, w in sweep.items()},
          "sweep_best_lm_scale": best_scale, "sweep_best_wer": best_stats.wer,
          "wer_mbr": wer_of(mbr_hyps), "mbr_mean_expected_wer": float(np.mean(exp_wer))
          if exp_wer else None, "mbr_malformed": mbr_bad,
          "ctm_lines": ctm_lines, "ctm_malformed": ctm_bad,
          "ctm_search_ended_inside_a_word": ctm_ends_inside_a_word,
          "post_frame_sum_max_err": post_err,
          "archive_bytes": ark_bytes, "archive_differs": archive_differ,
          "biglm_identity_differs": identity_differ, "wer_biglm_4gram": big_wer,
          "rnnlm": {"options": dataclasses.asdict(ropts), "vocab": rlm.vocab,
                    "sentences": len(train), "steps": len(losses),
                    "perplexity_by_epoch": [h["perplexity"] for h in hist],
                    "loss_first_50": float(np.mean(losses[:50])),
                    "loss_last_50": float(np.mean(losses[-50:])),
                    "step_ms_median": 1e3 * statistics.median(hist[0]["step_seconds"]),
                    "peak_device_memory_bytes": rnn_peak,
                    "held_out_score_card_vs_cpu_max_abs": score_diff,
                    "one_step_loss": step, "one_step_loss_rel_diff": step_rel,
                    "nbest": NBEST, "wer_rescored": rnn_wer},
          "decode_stages": d1, "decode_determinized_stages": d2, **stages,
          "wall_seconds": wall,
          "launches": counts})
    if min(counts["gather"], counts["mfcc"], counts["gmm"]) == 0:
        faults.append(f"lattice_outputs did not go through K1, K2 and K3: {counts}")
    if len(raw) != len(keys) or det_differ:
        faults.append(f"native vs Python determinization differ on {det_differ}")
    if decode_det_differ:
        faults.append(f"decode(determinize=True) differs from the native determinization "
                      f"of the raw lattices on {decode_det_differ}")
    if best_differ:
        faults.append(f"lattice best paths differ from the decoder's on {best_differ}")
    if mbr_bad or ctm_bad or post_err > POST_SUM_TOL:
        faults.append(f"malformed outputs: MBR {mbr_bad}, CTM {ctm_bad}, posteriors {post_err}")
    if archive_differ:
        faults.append(f"the archive read back differs on {archive_differ}")
    if identity_differ or not big_wer <= map_wer + 1.0:
        faults.append(f"decode_biglm: identity differs on {identity_differ}, 4-gram WER "
                      f"{big_wer} against {map_wer}")
    if not (np.mean(losses[-50:]) < np.mean(losses[:50]) and score_diff <= RNNLM_SCORE_TOL
            and step_rel <= RNNLM_STEP_TOL):
        faults.append(f"rnnlm: loss {np.mean(losses[:50])} -> {np.mean(losses[-50:])}, "
                      f"card vs CPU {score_diff} nats, one step {step}")
    # K1 and K3 at this path's shapes
    tg = c.token_budget(dopts.max_active)
    k1 = {"lattice_outputs": c.gather_at(len(keys), gmm.am.num_pdfs, tg, 768)}
    _, padded, _ = c.pad_feature_batch(feats)
    x = torch.from_numpy(padded.reshape(-1, padded.shape[-1])).to(dev)
    k3 = {"lattice_outputs": c.k3_at(torch, c.gmm_loglikes, c.gmm_loglikes_plain,
                                     gmm.am.weights(), x, c.plug)}
    del x, clats, rlm
    torch.cuda.empty_cache()
    return {"launches": counts, "k1": k1, "k3": k3, "faults": faults, "lattices": raw}


# the remaining nnet3 architectures (phases architectures, architectures_parity,
# stream_lstm): the JAX package's factories at their own widths, trained on the
# 600 training utterances from tri_ali.pkl's labels, decoded and streamed
ARCH_EPOCHS = 2  # NnetTrainOptions' 6 and MinilibOptions' 4, cut for time (PERF.md §4)
ARCH_MAX_WER_PERCENT = 5.0  # a broken model reads tens of per cent
ARCH_TOL = 1e-4  # card vs CPU: a step's loss (relative), logits and loglikes (of max|ref|)
ARCH_CHECK_UTTS = 8  # held-out utterances of the loglikes check
ARCH_TIMED_STEPS = 5  # card steps timed one by one for the median step time
FBANK_BINS = 40  # the CNN-TDNN-F's mel grid (make_cnn_tdnnf's height)
FEAT_DEVICE_TOL = 1e-4  # Fbank and PLP, card vs CPU, absolute
STREAM_LSTM_CHUNK_SECONDS = 0.5
STREAM_LSTM_UTTS = 8  # PR 14's 16, cut for the cli phase's time (PERF.md §4)
# xconfig models at the recipes' widths (cell 512) whose forward and one step
# are held card vs CPU: a BLSTMP, a projected GRU and the Descriptor DAG of
# tests/test_descriptor.py scaled to width 512
ARCH_PARITY_XCONFIGS = {
    "blstmp": """input name=input dim=39
relu-batchnorm-layer name=tdnn1 dim=512 input=Append(-2,-1,0,1,2)
blstmp-layer name=blstm1 cell-dim=512 recurrent-projection-dim=128 non-recurrent-projection-dim=128
relu-batchnorm-layer name=tdnn2 dim=512 input=Append(-3,0,3)
blstmp-layer name=blstm2 cell-dim=512 recurrent-projection-dim=128 non-recurrent-projection-dim=128
output-layer name=output dim=2000""",
    "pgru": """input name=input dim=39
relu-batchnorm-layer name=tdnn1 dim=512 input=Append(-2,-1,0,1,2)
pgru-layer name=pgru1 cell-dim=512 recurrent-projection-dim=128 non-recurrent-projection-dim=128
relu-batchnorm-layer name=tdnn2 dim=512 input=Append(-3,0,3)
pgru-layer name=pgru2 cell-dim=512 recurrent-projection-dim=128 non-recurrent-projection-dim=128
output-layer name=output dim=2000""",
    "dag": """input name=input dim=39
relu-batchnorm-layer name=tdnn1 dim=512 input=Append(-1,0,1)
relu-batchnorm-layer name=tdnn2 dim=512
relu-batchnorm-layer name=tdnn3 dim=512 input=Sum(tdnn2, IfDefined(Offset(tdnn1, -3)))
relu-batchnorm-layer name=tdnn4 dim=512 input=Append(tdnn3, Failover(Offset(tdnn1, -6), tdnn2), Round(tdnn2, 3))
output-layer name=output dim=2000""",
}


def architectures(torch, np, c) -> dict:
    """Phases architectures, architectures_parity and stream_lstm; `c` holds
    main()'s objects.  Each path's launch counts are set to 0 just before it
    and read just after; a fault is collected and raised after the three
    phases.  Returns {"launches": {path: K1 and K2 counts}}."""
    import statistics

    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions
    from old_kaldi_git_tpu_torch.feat.compute import (
        Fbank, FbankOptions, Plp, PlpOptions, compute_utterance_fbank)
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs
    from old_kaldi_git_tpu_torch.models import tdnn
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.streaming_am import StreamingAmNnet
    from old_kaldi_git_tpu_torch.models.train import (
        NnetTrainOptions, TrainState, _chunk_batches, make_ce_train_step, make_optimizer)
    from old_kaldi_git_tpu_torch.models.xconfig import parse_xconfig
    from old_kaldi_git_tpu_torch.online.streaming import StreamingTokenDecoder
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer

    dev, card, emit, minilib, system = c.dev, c.card, c.emit, c.minilib, c.system
    cpu = torch.device("cpu")
    faults, launches = [], {}
    t_arch = time.perf_counter()
    tri, ali = minilib._tri_system("exp/minilib")
    num_pdfs = tri.am.num_pdfs
    labels = {k: np.asarray(alignment_to_pdfs(tri.tm, a), np.int32)
              for k, a in ali.items() if a is not None}
    aopts = dataclasses.replace(c.topts, num_epochs=ARCH_EPOCHS)
    test_text = {k: list(v) for k, v in system.test_text.items()}

    def fbank_feats(waves):
        return compute_utterance_fbank(waves, minilib.SAMP_FREQ, dev, FBANK_BINS)

    def mfcc_feats(waves):
        return minilib.compute_feats(waves, device=dev)

    def on(am, device):
        """A copy of `am` on `device`."""
        return AmNnet(am.config, copy.deepcopy(am.model),
                      None if am.log_priors is None else am.log_priors.cpu().numpy(),
                      device=device)

    def first_batch(feats):
        keys = [k for k in sorted(feats) if k in labels]
        return next(_chunk_batches({k: feats[k] for k in keys}, labels, 140, 16,
                                   np.random.default_rng(0)))

    def step_parity(am, batch, timed=0):
        """One make_ce_train_step update (NnetTrainOptions()) from am's
        weights on `batch`, on the card and on the CPU: the two losses, and
        the card's seconds of `timed` more steps, each ended by a
        synchronise."""
        out, secs = {}, []
        for where, device in (("card", dev), ("cpu", cpu)):
            model = copy.deepcopy(am.model).to(device).train()
            opt = make_optimizer(NnetTrainOptions(), 100)
            step = make_ce_train_step(model, opt)
            state = TrainState(opt.init(dict(model.named_parameters())), 0)
            state, m = step(state, *batch)
            out[where] = float(m["loss"])
            for _ in range(timed if where == "card" else 0):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, *batch)
                float(m["loss"])
                secs.append(time.perf_counter() - t0)
            del model
        rel = abs(out["card"] - out["cpu"]) / abs(out["cpu"])
        return {"loss_card": out["card"], "loss_cpu": out["cpu"], "relative": rel}, secs

    def rel_gap(got, want):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
        return float(np.abs(got - want).max() / np.abs(want).max())

    # ---- architectures: train, decode, card vs CPU ----------------------------
    specs = [("tdnn_lstm", tdnn.make_tdnn_lstm(39, num_pdfs), mfcc_feats, "mfcc"),
             ("tdnn_attention", tdnn.make_tdnn_attention(39, num_pdfs), mfcc_feats, "mfcc"),
             ("cnn_tdnnf", tdnn.make_cnn_tdnnf(FBANK_BINS, num_pdfs), fbank_feats,
              f"fbank{FBANK_BINS}")]
    trained, mfcc_train = {}, None
    check_keys = sorted(system.test_waves)[:ARCH_CHECK_UTTS]
    for name, config, front_end, feat_kind in specs:
        t_model = time.perf_counter()
        c.zero_counts()
        t0 = time.perf_counter()
        feats = front_end(c.twaves)
        torch.cuda.synchronize()
        fe_s = time.perf_counter() - t0
        hist, tim = [], {}
        am = minilib.train_am_system(None, feats, aopts, device=dev, history=hist,
                                     timings=tim, config=config)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        tr_counts = c.read_counts(f"architectures_{name}")
        peak = torch.cuda.max_memory_allocated()
        c.zero_counts()
        stages = {}
        t0 = time.perf_counter()
        if feat_kind == "mfcc":
            wer, _ = minilib.decode_and_score(
                dataclasses.replace(system, am=am), beam=BEAM, max_active=MAX_ACTIVE,
                acoustic_scale=ACOUSTIC_SCALE, batch=BATCH, timings=stages)
            stats = minilib.decode_and_score.last_stats
            errors, ref_words = stats["errors"], stats["ref_words"]
        else:
            tfe = fbank_feats(system.test_waves)
            hyps = minilib.decode_features(
                dataclasses.replace(system, am=am), tfe, beam=BEAM, max_active=MAX_ACTIVE,
                acoustic_scale=ACOUSTIC_SCALE, batch=BATCH, timings=stages)
            ws = compute_wer(test_text, hyps)
            wer, errors, ref_words = ws.wer, ws.errors, ws.ref_len
        torch.cuda.synchronize()
        decode_wall = time.perf_counter() - t0
        de_counts = c.read_counts(f"architectures_{name}_decode")
        launches[f"architectures_{name}"] = tr_counts
        launches[f"architectures_{name}_decode"] = de_counts
        # card vs CPU: one step from the trained weights, and the loglikes
        step, secs = step_parity(am, first_batch(feats), timed=ARCH_TIMED_STEPS)
        _, xs, _ = pad_feature_batch(front_end({k: system.test_waves[k] for k in check_keys}))
        ll_gap = rel_gap(am.loglikes_batch(xs), on(am, cpu).loglikes_batch(xs))
        ce = [h["loss"] for h in hist]
        emit({"phase": "architectures", "card": card, "architecture": name,
              "config": f"{name}({config.input_dim}, {num_pdfs}) at the JAX factory's "
                        "widths", "features": feat_kind,
              "layers": [l.kind for l in config.layers],
              "parameters": sum(p.numel() for p in am.model.parameters()),
              "utterances": len(feats), "epochs": len(hist), "steps": tim["steps"],
              "ce_by_epoch": ce, "accuracy_by_epoch": [h["acc"] for h in hist],
              "front_end_seconds": fe_s, "train_seconds": tim["train_seconds"],
              "priors_seconds": tim["priors_seconds"], "train_wall_seconds": train_wall,
              "step_ms_mean": 1e3 * tim["train_seconds"] / tim["steps"],
              "step_ms_median": 1e3 * statistics.median(secs),
              "peak_device_memory_bytes": peak,
              "decode": {"graph": "exp/minilib/hclg.npz", "max_active": MAX_ACTIVE,
                         "batch": BATCH, "beam": BEAM, "wer_percent": wer, "errors": errors,
                         "ref_words": ref_words, "wall_seconds": decode_wall, **stages},
              "one_step_card_vs_cpu": step,
              "loglikes_card_vs_cpu_of_max": ll_gap, "loglikes_utterances": len(check_keys),
              "launches": {"train": tr_counts, "decode": de_counts},
              "phase_seconds": time.perf_counter() - t_model})
        if not (len(ce) == ARCH_EPOCHS and all(np.isfinite(ce))
                and all(b < a for a, b in zip(ce, ce[1:]))):
            faults.append(f"{name}: CE by epoch {ce}, not {ARCH_EPOCHS} finite and falling")
        if not wer <= ARCH_MAX_WER_PERCENT:
            faults.append(f"{name}: WER {wer} % above {ARCH_MAX_WER_PERCENT} %")
        if not step["relative"] <= ARCH_TOL:
            faults.append(f"{name}: one step's loss card vs CPU {step}")
        if not ll_gap <= ARCH_TOL:
            faults.append(f"{name}: loglikes card vs CPU {ll_gap} of max|ref|")
        if de_counts["gather"] == 0 or (feat_kind == "mfcc" and (
                tr_counts["mfcc"] == 0 or de_counts["mfcc"] == 0)):
            faults.append(f"{name} did not go through its kernels: {tr_counts}, {de_counts}")
        trained[name] = am
        if name == "tdnn_lstm":
            mfcc_train = feats
        del feats
        torch.cuda.empty_cache()

    # ---- architectures_parity: xconfig models at width 512, the front ends ----
    t_par = time.perf_counter()
    batch = first_batch(mfcc_train)
    parity = {}
    for name, text in ARCH_PARITY_XCONFIGS.items():
        config = parse_xconfig(text)
        am = AmNnet.init(config, seed=0, device=dev)
        with torch.no_grad():
            gap = rel_gap(am.logits(batch[0]), on(am, cpu).logits(batch[0]))
        step, secs = step_parity(am, batch, timed=2)
        parity[name] = {"layers": [l.kind for l in config.layers],
                        "parameters": sum(p.numel() for p in am.model.parameters()),
                        "logits_card_vs_cpu_of_max": gap, "one_step_card_vs_cpu": step,
                        "step_ms_median": 1e3 * statistics.median(secs)}
        if not (gap <= ARCH_TOL and step["relative"] <= ARCH_TOL):
            faults.append(f"architectures_parity {name}: {parity[name]}")
        del am
    fkeys = sorted(system.test_waves)[:STREAM_UTTS]
    wlen = max(len(system.test_waves[k]) for k in fkeys)
    wav = np.zeros((len(fkeys), wlen), np.float32)
    for i, k in enumerate(fkeys):
        wav[i, : len(system.test_waves[k])] = system.test_waves[k]
    front = {}
    for name, comp in (("fbank", Fbank(FbankOptions())), ("plp", Plp(PlpOptions()))):
        comp.opts.frame_opts.samp_freq = minilib.SAMP_FREQ
        comp.opts.frame_opts.dither = 0.0
        if name == "fbank":
            comp.opts.mel_opts.num_bins = FBANK_BINS
        x_card = torch.from_numpy(wav).to(dev)
        got, want = comp(x_card), comp(torch.from_numpy(wav))
        err = float((got.cpu() - want).abs().max())
        front[name] = {"shape": list(want.shape), "max_abs_err": err,
                       "card_ms": time_ms(torch, lambda: comp(x_card), reps=10)}
        if not err <= FEAT_DEVICE_TOL:
            faults.append(f"architectures_parity {name}: card vs CPU {err}")
    emit({"phase": "architectures_parity", "card": card, "batch": list(batch[0].shape),
          "models": parity, "front_ends": front, "utterances": len(fkeys),
          "phase_seconds": time.perf_counter() - t_par})

    # ---- stream_lstm: StreamingAmNnet into StreamingTokenDecoder --------------
    t_str = time.perf_counter()
    by_dur = sorted(system.test_waves, key=lambda k: len(system.test_waves[k]))
    skeys = by_dur[::len(by_dur) // STREAM_LSTM_UTTS][:STREAM_LSTM_UTTS]
    swaves = {k: system.test_waves[k] for k in skeys}
    saudio_s = sum(len(w) for w in swaves.values()) / minilib.SAMP_FREQ
    chunk = int(round(STREAM_LSTM_CHUNK_SECONDS * 100))  # frames at a 10 ms shift
    svopts = ViterbiOptions(beam=BEAM, max_active=STREAM_MAX_ACTIVE, acoustic_scale=1.0)
    streams = {}
    for name, front_end in (("tdnn_lstm", mfcc_feats), ("cnn_tdnnf", fbank_feats)):
        am = trained[name]
        want = minilib.decode_features(dataclasses.replace(system, am=am),
                                       front_end(swaves), BEAM, STREAM_MAX_ACTIVE, 1.0,
                                       batch=STREAM_LSTM_UTTS)
        dec = StreamingTokenDecoder(system.csr, lambda x: x, c.sil, c.tid_to_phone, svopts,
                                    chunk_quantum=STREAM_CHUNK, device=dev)
        c.zero_counts()
        t0 = time.perf_counter()
        feats = front_end(swaves)
        got, streamed, frames = {}, {}, 0
        for k in skeys:
            f = feats[k]
            sam = StreamingAmNnet(am)
            dec.reset()
            outs = []
            for lo in range(0, len(f), chunk):
                ll = sam.accept(f[lo: lo + chunk], final=lo + chunk >= len(f))
                if ll.size:
                    dec.advance(ll, final=lo + chunk >= len(f))
                    outs.append(ll)
            got[k] = [system.words[w] for w in dec.best_words()]
            streamed[k] = np.concatenate(outs)
            frames += len(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = c.read_counts(f"stream_lstm_{name}")
        launches[f"stream_lstm_{name}"] = counts
        gap = 0.0
        for k in skeys:
            whole = am.loglikes_batch(feats[k][None])[0].cpu().numpy()
            gap = max(gap, float(np.abs(streamed[k] - whole).max() / np.abs(whole).max()))
        differ = sorted(k for k in skeys if got[k] != want[k])
        ws = compute_wer({k: test_text[k] for k in skeys}, got)
        streams[name] = {"utterances_differing_from_batch": differ, "wer_percent": ws.wer,
                         "loglikes_stream_vs_whole_of_max": gap, "search_frames": frames,
                         "stream_wall_seconds": wall, "single_stream_rtf": wall / saudio_s,
                         "ms_per_frame": 1e3 * wall / frames,
                         "gather_launches": counts["gather"], "mfcc_launches": counts["mfcc"]}
        if differ:
            faults.append(f"stream_lstm {name}: {len(differ)} utterances differ from the "
                          f"batch decode: {differ}")
        if not gap <= ARCH_TOL:
            faults.append(f"stream_lstm {name}: streamed loglikes off the whole by {gap}")
        if counts["gather"] != frames:
            faults.append(f"stream_lstm {name}: {counts['gather']} gathers for {frames} "
                          "search frames (one a frame expected)")
        del dec
    emit({"phase": "stream_lstm", "card": card, "utterances": skeys,
          "chunk_seconds": STREAM_LSTM_CHUNK_SECONDS, "max_active": STREAM_MAX_ACTIVE,
          "beam": BEAM, "audio_seconds": saudio_s, "models": streams,
          "phase_seconds": time.perf_counter() - t_str,
          "all_three_phases_seconds": time.perf_counter() - t_arch})
    del trained
    torch.cuda.empty_cache()
    if faults:
        raise RuntimeError("architectures: " + "; ".join(faults))
    return {"launches": launches, "feats": mfcc_train, "labels": labels, "num_pdfs": num_pdfs}


CLI_UTTS = 64  # held-out utterances of the feature, decode and TDNN tools
CLI_ONLINE_UTTS = 4  # of them, through the two online tools (cut from 8)
CLI_TCP_UTTS = 2  # of them, on one connection to the TCP server
CLI_TCP_GAP_SECONDS = 1.0  # the endpoint rule's silence; noise is sent up to 4 times it
CLI_ALIGN_UTTS = 64  # training utterances of the alignment tools
CLI_MAX_STATES = 300_000  # past this the unigram keeps the words seen twice
CLI_NNET_TOL = 1e-4  # nnet3-compute vs AmNnet.loglikes_batch, absolute


def cli_graph(workdir: str, max_states: int = CLI_MAX_STATES) -> dict:
    """The cli phase's graph, built in a spawned process through the CLI
    (host work only: the port's tools, the native graph library): the
    minilib lexicon as lexicon.txt → prepare-lang (its L held to the lang
    bundle's, array for array) → a unigram ARPA over the words of the 600
    training transcripts, counted from them → tree.pkl's tree as a Kaldi
    ContextDependency file → mkgraph --tree with tri.mdl."""
    import numpy as np

    from old_kaldi_git_tpu_torch import convert
    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.fst.vector_fst import read_arrays
    from old_kaldi_git_tpu_torch.lm.ngram import estimate_ngram_lm, write_arpa
    from old_kaldi_git_tpu_torch.recipes import minilib

    t_start = time.perf_counter()
    p = lambda *a: os.path.join(workdir, *a)  # noqa: E731
    opts = minilib.MinilibOptions()
    lex = minilib.make_lexicon(opts)
    with open(p("lexicon.txt"), "w") as f:
        for w in sorted(lex):
            f.write(f"{w} {lex[w]}\n")
    walls = {}

    def run(label, *argv):
        t0 = time.perf_counter()
        if tools.main(list(argv)) != 0:
            raise RuntimeError(f"cli graph: {argv[0]} failed")
        walls[label] = time.perf_counter() - t0

    run("prepare-lang", "prepare-lang", p("lexicon.txt"), p("lang"))
    bundle = minilib.make_lang(opts)
    l_equal = True
    for name, fst in (("L.fst", bundle.L), ("L_disambig.fst", bundle.L_disambig)):
        with open(p("lang", name), "rb") as f:
            got = read_arrays(f)
        want = fst.to_arrays()
        l_equal &= got[0] == want[0] and all(np.array_equal(a, b)
                                             for a, b in zip(got[1:], want[1:]))
    with open(p("lang", "words.txt")) as f:
        l_equal &= [ln.split()[0] for ln in f] == bundle.words.symbols()
    sents = [minilib._to_words(s) for s in minilib.make_text(
        opts, opts.num_train, opts.seed + 4, min_len=4, max_len=11)]
    with open(p("tree"), "wb") as f:
        convert.context_dependency_from_pickle(
            convert.load_pickle("exp/minilib/tree.pkl")[0]).write(f)
    counts = {}
    for s in sents:
        for w in s:
            counts[w] = counts.get(w, 0) + 1
    cut = None
    for min_count in (1, 2):
        kept = [[w for w in s if counts[w] >= min_count] for s in sents]
        write_arpa(estimate_ngram_lm([s for s in kept if s], order=1), p("G.arpa"))
        run(f"mkgraph_min_count_{min_count}", "mkgraph", f"--tree={p('tree')}", p("lang"),
            p("G.arpa"), os.path.abspath("exp/minilib/tri.mdl"), p("graph"))
        with open(p("graph", "HCLG.fst"), "rb") as f:
            f.read(8)
            _, states, arcs = struct.unpack("<iqi", f.read(16))
        words = sum(1 for c in counts.values() if c >= min_count)
        if states <= max_states:
            break
        cut = {"states_before": states, "arcs_before": arcs, "words_before": words}
    return {"workdir": workdir, "L_equal_to_bundle": bool(l_equal), "states": states,
            "arcs": arcs, "unigram_words": words, "cut_to_words_seen_twice": cut,
            "tool_seconds": walls, "seconds": time.perf_counter() - t_start}


def cli(torch, np, c) -> dict:
    """The cli phase: the port's command-line tools on the card, called
    in-process through bin.tools.main (one through a `python -m
    old_kaldi_git_tpu_torch.bin` subprocess), each held to the port's
    library on the same inputs.  The kernels' counts are set to 0 just
    before the tools run and read just after; the library references and the
    kernel checks at the phase's shapes come after."""
    import contextlib
    import io
    import socket
    import subprocess
    import threading

    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.decoder.csr import fst_to_csr_native
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import (
        ViterbiOptions, align_batch, align_shape, decode_batch)
    from old_kaldi_git_tpu_torch.feat.compute import MfccOptions, compute_utterance_feats
    from old_kaldi_git_tpu_torch.fst.native import NativeFst
    from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_best_path
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet, AmNnetModel
    from old_kaldi_git_tpu_torch.models.streaming_am import StreamingAmNnet
    from old_kaldi_git_tpu_torch.online.streaming import (
        OnlineFeaturePipeline, StreamingDecoder)
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
    from old_kaldi_git_tpu_torch.utils.wav import WaveData

    t_start = time.perf_counter()
    dev, minilib, sr = c.dev, c.minilib, c.minilib.SAMP_FREQ
    wd = c.workdir
    p = lambda *a: os.path.join(wd, *a)  # noqa: E731
    tri, final_am = os.path.abspath("exp/minilib/tri.mdl"), os.path.abspath("exp/minilib/final.am")
    faults = []
    walls = {}

    def run(label, *argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = tools.main(list(argv))
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli: {label} exited {rc}")

    # inputs, before the counts start: the first 64 clean held-out waves as a
    # wave archive with wav.scp (int16 samples, as a wav file holds them),
    # the first 64 training utterances' transcripts and features (library)
    keys = sorted(c.system.test_waves)[:CLI_UTTS]
    with TableWriter(f"ark,scp:{p('wav.ark')},{p('wav.scp')}", "wav") as w:
        for k in keys:
            w[k] = WaveData(samp_freq=sr, data=np.asarray(c.system.test_waves[k],
                                                          np.float32)[None])
    waves = {k: v.data[0] for k, v in read_table(f"scp:{p('wav.scp')}", "wav").items()}
    with open(p("wav.scp")) as f:
        scp_lines = f.readlines()
    with open(p("wav_online.scp"), "w") as f:
        f.writelines(scp_lines[:CLI_ONLINE_UTTS])
    with TableWriter(f"ark,t:{p('ref.txt')}", "text") as w:
        for k in keys:
            w[k] = " ".join(c.system.test_text[k])
    tkeys = sorted(c.twaves)[:CLI_ALIGN_UTTS]
    with TableWriter(f"ark,t:{p('train_text.txt')}", "text") as w:
        for k in tkeys:
            w[k] = " ".join(c.ttext[k])
    tfeats = minilib.compute_feats({k: c.twaves[k] for k in tkeys}, device=dev)
    with TableWriter(f"ark:{p('train_feats.ark')}", "mat") as w:
        for k in tkeys:
            w[k] = tfeats[k]
    sil = str(c.sil[0])
    t_phase = time.perf_counter()
    c.zero_counts()
    c.gmm_loglikes.launches = 0
    # ---- features: MFCC (K2) → per-utterance CMVN → deltas; the deltas
    # through the module entry in a subprocess
    run("compute-mfcc-feats", "compute-mfcc-feats", f"--samp-freq={sr}", "--dither=0",
        f"scp:{p('wav.scp')}", f"ark:{p('raw.ark')}")
    run("compute-cmvn-stats", "compute-cmvn-stats", f"ark:{p('raw.ark')}",
        f"ark:{p('cmvn.ark')}")
    run("apply-cmvn", "apply-cmvn", f"ark:{p('cmvn.ark')}", f"ark:{p('raw.ark')}",
        f"ark:{p('cmn.ark')}")
    # the deltas through the module entry in a subprocess too, whose archive
    # must be the in-process tool's bytes; its start (8-12 s) overlaps the
    # tools below
    module_entry = subprocess.Popen(
        [sys.executable, "-m", "old_kaldi_git_tpu_torch.bin", "add-deltas",
         f"ark:{p('cmn.ark')}", f"ark:{p('feats_module.ark')}"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    run("add-deltas", "add-deltas", f"ark:{p('cmn.ark')}", f"ark:{p('feats.ark')}")
    # ---- the graph, built in its own process since the phase's start
    t0 = time.perf_counter()
    graph = c.graph_future.result()
    graph_wait = time.perf_counter() - t0
    c.graph_pool.shutdown()
    if graph["workdir"] != wd:
        raise RuntimeError("cli: the graph was built in another directory")
    hclg, words_txt = p("graph", "HCLG.fst"), p("graph", "words.txt")
    wt = f"--word-symbol-table={words_txt}"
    # ---- GMM decode (K3) → best path → WER
    run("gmm-latgen-faster", "gmm-latgen-faster", wt, tri, hclg, f"ark:{p('feats.ark')}",
        f"ark:{p('lat.ark')}", f"ark,t:{p('gmm_words.txt')}")
    run("lattice-best-path", "lattice-best-path", wt, f"ark:{p('lat.ark')}",
        f"ark,t:{p('bp_words.txt')}")
    t0 = time.perf_counter()

    def text_sink():  # a stdout with a .buffer, as the table writers expect
        return io.TextIOWrapper(io.BytesIO(), encoding="utf-8")

    wer_out = text_sink()
    with contextlib.redirect_stdout(wer_out):
        if tools.main(["compute-wer", f"ark:{p('ref.txt')}",
                       f"ark:{p('gmm_words.txt')}"]) != 0:
            raise RuntimeError("cli: compute-wer failed")
    walls["compute-wer"] = time.perf_counter() - t0
    # ---- TDNN: bundle, loglikes, decode
    run("nnet3-am-init", "nnet3-am-init", tri, final_am, p("final.mdl"))
    run("nnet3-compute", "nnet3-compute", final_am, f"ark:{p('feats.ark')}",
        f"ark:{p('nnet_ll.ark')}")
    run("nnet3-latgen-faster", "nnet3-latgen-faster", wt, p("final.mdl"), hclg,
        f"ark:{p('feats.ark')}", f"ark:{p('nlat.ark')}", f"ark,t:{p('nnet_words.txt')}")
    # ---- online: 4 utterances through each online tool, 2 through the server
    online = [wt, f"--samp-freq={sr}", f"--silence-phone-id={sil}"]
    with contextlib.redirect_stdout(text_sink()):
        run("online-wav-gmm-latgen-faster", "online-wav-gmm-latgen-faster", *online, tri,
            hclg, f"scp:{p('wav_online.scp')}", f"ark,t:{p('online_gmm.txt')}")
        run("online2-wav-nnet3-latgen-faster", "online2-wav-nnet3-latgen-faster", *online,
            p("final.mdl"), hclg, f"scp:{p('wav_online.scp')}", f"ark,t:{p('online_nnet.txt')}")
    # the server reads 0.18 s chunks (its default) and starts a new
    # utterance at an endpoint; the first utterance, padded with noise to
    # whole chunks, is followed by noise a chunk at a time until the server
    # answers its final line, so that the second utterance reaches a fresh
    # pipeline and decoder exactly as the online2-wav tool's does
    rng = np.random.default_rng(15)
    cs = int(0.18 * sr)
    tcp_keys = keys[:CLI_TCP_UTTS]
    first = waves[tcp_keys[0]]
    first = np.concatenate([first, 40.0 * rng.standard_normal(-len(first) % cs)])

    def pcm(x):
        return np.clip(x, -32768, 32767).astype("<i2").tobytes()

    rcs, received = [], b""
    if os.path.exists(p("tcp.port")):
        os.remove(p("tcp.port"))
    server = threading.Thread(target=lambda: rcs.append(tools.main([
        "online2-tcp-nnet3-decode-faster", "--port-num=0", f"--port-file={p('tcp.port')}",
        "--num-connections=1", *online, p("final.mdl"), hclg])), daemon=True)
    t0 = time.perf_counter()
    server.start()
    while not (os.path.exists(p("tcp.port")) and open(p("tcp.port")).read().strip()):
        if not server.is_alive():
            raise RuntimeError("cli: the TCP server ended before it bound a port")
        time.sleep(0.05)
    with socket.create_connection(("127.0.0.1", int(open(p("tcp.port")).read())),
                                  timeout=300) as conn:

        def read_until(n_partials, wait):
            nonlocal received
            conn.settimeout(wait)
            while received.count(b"\r") < n_partials or wait < 1.0:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    break
                if not data:
                    break
                received += data
            conn.settimeout(300)

        def read_final(wait):
            """Until the endpoint's final line has come, or `wait` seconds of
            nothing: the server sends it after the chunk's partial, once its
            search's best path is read back."""
            nonlocal received
            conn.settimeout(wait)
            while b"\n" not in received:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    break
                if not data:
                    break
                received += data
            conn.settimeout(300)

        conn.sendall(pcm(first))
        sent = len(first) // cs
        read_until(sent, 300.0)
        gap_chunks = 0
        while b"\n" not in received and gap_chunks * cs < CLI_TCP_GAP_SECONDS * 4 * sr:
            conn.sendall(pcm(40.0 * rng.standard_normal(cs)))
            sent += 1
            gap_chunks += 1
            read_until(sent, 300.0)
            # once the noise is long enough for the endpoint rule, its final
            # line may follow this partial: a noise chunk sent before it
            # arrives would open the next utterance (a slow host's readback
            # can outlast 0.3 s)
            read_final(0.3 if gap_chunks * cs < CLI_TCP_GAP_SECONDS * sr else 5.0)
        conn.sendall(pcm(waves[tcp_keys[1]]))
        conn.shutdown(socket.SHUT_WR)
        conn.settimeout(300)
        while True:
            data = conn.recv(65536)
            if not data:
                break
            received += data
    server.join(timeout=300)
    walls["online2-tcp-nnet3-decode-faster"] = time.perf_counter() - t0
    if rcs != [0]:
        raise RuntimeError(f"cli: the TCP server returned {rcs}")
    tcp_gap_seconds = gap_chunks * cs / sr
    # ---- alignment: training graphs, then the three aligners (K1)
    run("compile-train-graphs", "compile-train-graphs", p("tree"), tri, p("lang"), f"ark,t:{p('train_text.txt')}", f"ark:{p('graphs.ark')}")
    aligners = (("gmm-align-compiled", tri), ("align-equal-compiled", tri),
                ("nnet3-align-compiled", p("final.mdl")))
    for name, mdl in aligners:
        run(name, name, mdl, f"ark:{p('graphs.ark')}", f"ark:{p('train_feats.ark')}",
            f"ark:{p(name + '.ark')}")
    torch.cuda.synchronize()
    tools_wall = time.perf_counter() - t_phase - graph_wait
    launches = c.read_counts("cli")
    launches["gmm"] = c.gmm_loglikes.launches
    t0 = time.perf_counter()
    _, err = module_entry.communicate(timeout=600)
    walls["add-deltas (python -m old_kaldi_git_tpu_torch.bin), the wait"] = (
        time.perf_counter() - t0)
    if module_entry.returncode != 0:
        raise RuntimeError(f"cli: the module entry's add-deltas exited "
                           f"{module_entry.returncode}: {err[-2000:]}")
    with open(p("feats_module.ark"), "rb") as f, open(p("feats.ark"), "rb") as g:
        if f.read() != g.read():
            faults.append("cli: the module entry's add-deltas wrote other bytes than the tool")

    # ---- the library on the same inputs
    words = SymbolTable.read(words_txt)
    text_of = lambda ids: " ".join(words[i] for i in ids)  # noqa: E731
    feats = read_table(f"ark:{p('feats.ark')}", "mat")
    want = compute_utterance_feats(waves, sr, dev, deltas=True)
    feat_err = {k: float(np.abs(feats[k] - want[k]).max()) if feats[k].shape == want[k].shape
                else float("inf") for k in keys}
    feat_ok = sorted(feats) == keys and all(
        feat_err[k] <= 1e-3 + 1e-5 * float(np.abs(want[k]).max()) for k in keys)
    if not feat_ok:
        faults.append(f"CLI features part from compute_utterance_feats: "
                      f"{max(feat_err.values())}")
    gmm = AmGmmModel.load(tri, device=dev)
    csr = read_hclg_csr(hclg, gmm.tm.tid_to_pdf_array())
    fkeys, fpad, fnf = pad_feature_batch(feats)
    fx = torch.from_numpy(fpad).to(dev)
    ll = gmm.am.loglikes_batch(fx)
    lib = decode_batch(csr, ll, fnf, ViterbiOptions(), want_lattice=True, device=dev)
    lib_plain = decode_batch(csr, ll, fnf, ViterbiOptions(), device=dev)
    tool_words = read_table(f"ark:{p('gmm_words.txt')}", "text")
    gmm_same = sum(tool_words.get(k) == text_of(r.words) for k, r in zip(fkeys, lib))
    plain_same = sum(text_of(a.words) == text_of(b.words) for a, b in zip(lib, lib_plain))
    lats = read_table(f"ark:{p('lat.ark')}", "lat")
    bp_same = 0
    end_words = {k: end_state_words(np, csr, r) for k, r in zip(fkeys, lib)}
    for k, r in zip(fkeys, lib):
        if k in lats:
            ws, _, _ = lattice_best_path(lats[k], 1.0, 0.1)
            bp_same += list(ws) + end_words[k] == list(r.words)
    wer_out.flush()
    wer_line = next((ln for ln in wer_out.buffer.getvalue().decode().splitlines()
                     if ln.startswith("%WER")), "")
    if gmm_same != len(keys) or bp_same != len(keys):
        faults.append(f"gmm-latgen-faster: words {gmm_same}/{len(keys)}, lattice best "
                      f"paths {bp_same}/{len(keys)}")
    del ll, lib, lib_plain
    am = AmNnet.load(final_am, device=dev)
    nll = read_table(f"ark:{p('nnet_ll.ark')}", "mat")
    nnet_err = max(float(np.abs(nll[k] - am.loglikes_batch(feats[k][None])[0].cpu().numpy()
                                ).max()) for k in keys)
    if not nnet_err <= CLI_NNET_TOL:
        faults.append(f"nnet3-compute parts from AmNnet.loglikes_batch by {nnet_err}")
    bundle = AmNnetModel.load(p("final.mdl"), device=dev)
    nlib = decode_batch(csr, bundle.am.loglikes_batch_chunked(fpad), fnf,
                        ViterbiOptions(acoustic_scale=1.0), want_lattice=True, device=dev)
    ntool = read_table(f"ark:{p('nnet_words.txt')}", "text")
    nnet_same = sum(ntool.get(k) == text_of(r.words) for k, r in zip(fkeys, nlib))
    if nnet_same != len(keys):
        faults.append(f"nnet3-latgen-faster: words {nnet_same}/{len(keys)}")
    del nlib
    # the library's streaming decoders fed as the online tools feed them
    mfcc_opts = MfccOptions()
    mfcc_opts.frame_opts.samp_freq, mfcc_opts.frame_opts.dither = sr, 0.0
    chunk = int(0.5 * sr)

    def stream(k, nnet):
        pipe = OnlineFeaturePipeline(mfcc_opts, device=dev)
        if nnet:
            sam = StreamingAmNnet(bundle.am)
            dec = StreamingDecoder(csr, lambda x: x, [int(sil)],
                                   bundle.tm.tid_to_phone_array(),
                                   ViterbiOptions(acoustic_scale=1.0), device=dev)
        else:
            dec = StreamingDecoder(csr, gmm.am.loglikes_batch, [int(sil)],
                                   gmm.tm.tid_to_phone_array(), ViterbiOptions(), device=dev)
        x = waves[k]
        for lo in range(0, len(x), chunk):
            f = pipe.accept_waveform(x[lo: lo + chunk])
            dec.advance(sam.accept(f) if nnet else f)
            if dec.endpoint_detected():
                if nnet:
                    return text_of(dec.best_words())
                break
        f = pipe.input_finished()
        dec.advance(sam.accept(f, final=True) if nnet else f, final=True)
        return text_of(dec.best_words())

    okeys = keys[:CLI_ONLINE_UTTS]
    online_gmm = read_table(f"ark:{p('online_gmm.txt')}", "text")
    online_nnet = read_table(f"ark:{p('online_nnet.txt')}", "text")
    ogmm_same = sum(online_gmm.get(k) == stream(k, False) for k in okeys)
    onnet_same = sum(online_nnet.get(k) == stream(k, True) for k in okeys)
    text = received.decode()
    finals = [seg.split("\r")[-1].strip() for seg in text.split("\n") if seg.strip("\r")]
    tcp_want = [online_nnet.get(k) for k in tcp_keys]
    if (ogmm_same, onnet_same) != (len(okeys), len(okeys)) or finals != tcp_want:
        faults.append(f"online tools: gmm {ogmm_same}/{len(okeys)}, nnet3 {onnet_same}/"
                      f"{len(okeys)}, TCP finals {finals} against {tcp_want}")
    # the aligners against align_batch on the same graphs and loglikes
    graphs = read_table(f"ark:{p('graphs.ark')}", "fst")
    akeys, apad, anf = pad_feature_batch({k: tfeats[k] for k in tkeys if k in graphs})
    ax = torch.from_numpy(apad).to(dev)
    align_same, k1_shapes = {}, {}
    for name, mdl in aligners:
        model = bundle if name.startswith("nnet3") else gmm
        t2p = model.tm.tid_to_pdf_array()
        acsr = [fst_to_csr_native(NativeFst.from_arrays(*graphs[k].to_arrays()), t2p)
                for k in akeys]
        if name == "align-equal-compiled":
            all_ = torch.zeros((len(akeys), apad.shape[1], gmm.am.num_pdfs), device=dev)
            vo = ViterbiOptions(beam=1e9, acoustic_scale=1.0)
        else:
            all_ = model.am.loglikes_batch(ax)
            vo = ViterbiOptions(beam=200.0, acoustic_scale=1.0)
        alis, _ = align_batch(acsr, all_, anf, vo, device=dev)
        got = read_table(f"ark:{p(name + '.ark')}", "ivec")
        align_same[name] = sum(a is not None and k in got and np.array_equal(got[k], a)
                               for k, a in zip(akeys, alis))
        S, A = align_shape(acsr)
        k1_shapes[name] = (S, A, int(all_.shape[-1]))
        del all_
    if any(v != len(tkeys) for v in align_same.values()) or len(akeys) != len(tkeys):
        faults.append(f"aligners: tids equal on {align_same} of {len(tkeys)}")

    # ---- the kernels at the phase's new shapes, against their plain versions
    S, A, Pa = k1_shapes["gmm-align-compiled"]
    B = len(akeys)
    k1_err = c.check_gather(torch, c.batched_table_gather, c.batched_table_gather_plain,
                            [(B, Pa, A, 3, 1), (B, S, A, 1, 0), (B, Pa, A - 1, 3, 2)], seed=15)
    k1 = {"align_loglikes": c.gather_at(B, Pa, A, int(anf.max())),
          "align_alpha": c.gather_at(B, S, A, 1)}
    gw = gmm.am.weights()
    k3 = {"cli_decode_features": c.k3_at(torch, c.gmm_loglikes, c.gmm_loglikes_plain, gw,
                                          fx.reshape(-1, fx.shape[-1]).contiguous(), c.plug),
          "cli_align_features": c.k3_at(torch, c.gmm_loglikes, c.gmm_loglikes_plain, gw,
                                        ax.reshape(-1, ax.shape[-1]).contiguous(), c.plug)}
    del fx, ax
    torch.cuda.empty_cache()
    c.emit({"phase": "cli", "card": c.card, "utterances": len(keys),
            "online_utterances": len(okeys), "tcp_utterances": len(tcp_keys),
            "align_utterances": len(tkeys), "graph": {k: v for k, v in graph.items()
                                                      if k != "workdir"},
            "graph_wait_seconds": graph_wait, "tools_wall_seconds": tools_wall,
            "phase_seconds": time.perf_counter() - t_start,
            "tool_seconds": walls,
            "launches": {k: launches[k] for k in ("gather", "mfcc", "gmm")},
            "features_max_abs_err": max(feat_err.values()), "features_equal": feat_ok,
            "gmm_latgen_words_equal": gmm_same, "gmm_latgen_lattice_best_paths_equal": bp_same,
            "lattice_mode_words_vs_plain_decode_equal": plain_same, "compute_wer": wer_line,
            "nnet3_compute_max_abs_err": nnet_err, "nnet3_latgen_words_equal": nnet_same,
            "online_gmm_words_equal": ogmm_same, "online_nnet3_words_equal": onnet_same,
            "tcp_finals": finals, "tcp_partial_lines": text.count("\r"),
            "tcp_noise_seconds_to_the_endpoint": tcp_gap_seconds,
            "align_tids_equal": align_same,
            "gather_at_cli_shapes": {"exact": k1_err == 0.0, **k1},
            "gmm_at_cli_shapes": k3})
    if min(launches["gather"], launches["mfcc"], launches["gmm"]) == 0:
        faults.append(f"the cli phase did not go through every kernel: {launches}")
    return {"faults": faults, "launches": launches, "k1": k1, "k1_err": k1_err, "k3": k3,
            "end_words": end_words}


CLI_RNNLM_OPTS = dict(embed_dim=16, cell_dim=32, recurrent_dim=16, num_epochs=3)
CLI_RNNLM_TOL = 1e-3  # a rescored path's graph cost, card vs CPU (RNNLM_SCORE_TOL's rule)
CLI_ACC_REL = 1e-9  # gmm-acc-stats vs accumulate_corpus, of each array's max|ref|
CLI_IVEC_REL = 1e-9  # ivector-extract-online2 vs extract_online_ivectors on the card
CLI_IVEC_CPU_REL = 1e-4  # the same on the CPU (PR 11's rule), of each utterance's max|ref|
CLI_LAT_TOL = (1e-5, 2e-5)  # acoustic costs: atol + rtol·|cost| (tests/test_torch_cli_decode.py)
CLI_SMALL_LEXICON = 40  # words of the lexicon whose lang the fst* tools take
CLI_LATTICE_HOST_UTTS = 4  # of the 64 lattices, through the per-utterance host tools
CLI_CTM_UTTS = 2  # lattices through lattice-to-ctm-conf
CLI_RNNLM_CPU_UTTS = 16  # of the 64 rescored lattices, rescored again on the CPU


def lattices_close(a, b, atol: float, rtol: float) -> bool:
    """Equal arc for arc: labels and states exactly, graph costs within atol,
    acoustic costs within atol + rtol·|cost|."""
    if (a.num_states, a.start) != (b.num_states, b.start):
        return False
    for (ga, aa), (gb, ab) in zip(a.finals, b.finals):
        if (ga == float("inf")) != (gb == float("inf")):
            return False
        if ga != float("inf") and (abs(ga - gb) > atol or abs(aa - ab) > atol + rtol * abs(ab)):
            return False
    for xs, ys in zip(a.arcs, b.arcs):
        if len(xs) != len(ys):
            return False
        for x, y in zip(xs, ys):
            if ((x.ilabel, x.olabel, x.nextstate) != (y.ilabel, y.olabel, y.nextstate)
                    or abs(x.graph_cost - y.graph_cost) > atol
                    or abs(x.acoustic_cost - y.acoustic_cost) > atol + rtol * abs(y.acoustic_cost)):
                return False
    return True


def cli_lattice(torch, np, c) -> dict:
    """The cli_lattice phase: the second batch of command-line tools
    (bin/lat_tools.py, bin/util_tools.py: 66 tools) in-process through
    bin.tools.main, on the cli phase's work directory (its 64 clean held-out
    utterances' wave archive and CLI features, tri.mdl's lattices from
    gmm-latgen-faster and final.am's loglikes from nnet3-compute, the HCLG,
    lang dir, tree and unigram ARPA).  The kernels' counts are set to 0
    just before the tools run and read just after.  Each tool is then held
    to the port's library on the same inputs; a tool that reads an archived
    lattice's state times finds none (the state-time fault, ROADMAP queue 3),
    in the library too."""
    import contextlib
    import io
    import random

    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.fst import algorithms as falg
    from old_kaldi_git_tpu_torch.fst.context import add_subsequential_loop, compose_context
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.fst.rand import rand_fst
    from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst, linear_fst
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.mle import AccumAmDiagGmm, read_accs
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import split_to_phones
    from old_kaldi_git_tpu_torch.hmm.posterior import scale_post
    from old_kaldi_git_tpu_torch.ivector.extractor import (
        IvectorExtractor, extract_online_ivectors)
    from old_kaldi_git_tpu_torch.lat.ctm import (
        align_words_boundary, align_words_lexicon, lattice_to_ctm_conf)
    from old_kaldi_git_tpu_torch.lat.determinize import (
        determinize_lattice, minimize_compact_lattice, push_compact_lattice)
    from old_kaldi_git_tpu_torch.lat.discriminative import forward_backward_mpe_variants
    from old_kaldi_git_tpu_torch.lat.lattice import (
        Lattice, LatticeArc, lattice_best_path, lattice_interp, lattice_nbest_paths,
        lattice_state_times, lattice_to_post, lattice_to_word_fst, linear_lattice_from_path)
    from old_kaldi_git_tpu_torch.lat.rescore import (
        compose_lattice_pruned, lmrescore_compact_lattice, rescore_lattice_acoustics)
    from old_kaldi_git_tpu_torch.lm.arpa import arpa_to_fst, load_lm, parse_arpa
    from old_kaldi_git_tpu_torch.lm.rnnlm import RnnLmOptions, load_rnnlm, make_rnnlm
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer
    from old_kaldi_git_tpu_torch.utils.io_funcs import (
        init_kaldi_input_stream, read_matrix, read_vector)
    from old_kaldi_git_tpu_torch.utils.log import KaldiError
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

    t_start = time.perf_counter()
    dev, wd = c.dev, c.workdir
    on_card = dev.type == "cuda"
    p = lambda *a: os.path.join(wd, *a)  # noqa: E731
    tri = c.tri
    dev_opt = [] if on_card else ["--device=cpu"]
    faults, walls, checks = [], {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(label, *argv, rcs=(0,)):
        """A tool in-process: (exit code, what it printed); its wall under
        `label`, ended by a device synchronise."""
        out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tools.main(list(argv))
        sync()
        walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
        if rc not in rcs:
            raise RuntimeError(f"cli_lattice: {label} exited {rc}")
        out.flush()
        return rc, out.buffer.getvalue().decode()

    def data(name):
        with open(p(name), "rb") as f:
            return f.read()

    def same(name, path, holder, items):
        """The tool's archive at `path` byte for byte an archive of the
        library's (key, value) items, written as the tools write."""
        want = p(f"want_{name}")
        with TableWriter(f"ark:{want}", holder) as w:
            for k, v in items:
                w[k] = v
        checks[name] = data(path) == data(want)

    # ---- inputs, before the counts start (host work)
    keys = list(c.keys)
    sil = int(c.sil[0])
    hclg, words_txt = p("graph", "HCLG.fst"), p("graph", "words.txt")
    wt = f"--word-symbol-table={words_txt}"
    feats_r, lat_r = f"ark:{p('feats.ark')}", f"ark:{p('lat.ark')}"
    few_r = f"ark:{p('lat_few.ark')}"  # the lattices of the host tools
    rnn_cpu_r = f"ark:{p('lat_rnn_cpu.ark')}"  # those the RNNLM rescores on the CPU too
    words = SymbolTable.read(words_txt)
    with TableWriter(f"ark,t:{p('rnn_text.txt')}", "text") as w:
        for k in sorted(c.ttext):
            w[k] = " ".join(c.ttext[k])
    os.makedirs(p("data"), exist_ok=True)
    with open(p("wav.scp")) as f, open(p("data", "wav.scp"), "w") as g:
        g.write(f.read())
    ref = read_table(f"ark:{p('ref.txt')}", "text")
    with open(p("data", "text"), "w") as f:
        f.writelines(f"{k} {ref[k]}\n" for k in keys)
    with open(p("data", "utt2spk"), "w") as f:
        f.writelines(f"{k} spk{i % 8}\n" for i, k in enumerate(keys))
    # a lang of the lexicon's first words, for the fst* tools (prepare-lang:
    # the cli phase's tool), its LG through the library, and a top-level
    # grammar whose word 1 expands into a sub-FST
    with open(p("lexicon.txt")) as f:
        small = [next(f) for _ in range(CLI_SMALL_LEXICON)]
    with open(p("small_lexicon.txt"), "w") as f:
        f.writelines(small)
    if tools.main(["prepare-lang", p("small_lexicon.txt"), p("small_lang")]) != 0:
        raise RuntimeError("cli_lattice: prepare-lang of the small lexicon failed")
    small_words = SymbolTable.read(p("small_lang", "words.txt"))
    small_arpa = ("\\data\\\nngram 1=%d\n\n\\1-grams:\n" % (len(small) + 2)
                  + "".join(f"-1.5\t{ln.split()[0]}\n" for ln in small)
                  + "-1.5\t</s>\n-99\t<s>\n\n\\end\\\n")
    with open(p("small.arpa"), "w") as f:
        f.write(small_arpa)
    with open(p("small_G.fst"), "wb") as f:
        arpa_to_fst(parse_arpa(small_arpa), small_words).write(f)
    with open(p("small_lang", "phones.txt")) as f:
        small_disambig = [int(i) for sym, i in (ln.split() for ln in f) if sym.startswith("#")]
    with open(p("disambig.int"), "w") as f:
        f.write(" ".join(map(str, small_disambig)) + "\n")
    with open(p("loops_in.int"), "w") as f:
        f.write(f"{small_disambig[0]}\n")
    with open(p("loops_out.int"), "w") as f:
        f.write("0\n")
    for name, fst in (("top.fst", linear_fst([2, 1, 3])), ("sub.fst", linear_fst([4, 5]))):
        with open(p(name), "wb") as f:
            fst.write(f)
    fmat = read_table(feats_r, "mat")
    for path, n in ((few_r, CLI_LATTICE_HOST_UTTS), (rnn_cpu_r, CLI_RNNLM_CPU_UTTS)):
        with TableWriter(path, "lat") as w:
            for k, v in list(read_table(lat_r, "lat").items())[:n]:
                w[k] = v
    # lattice-to-ctm-conf stops at the first lattice whose best path it
    # cannot align to the lexicon (a best path without its end state's
    # words: ROADMAP queue 3), so it reads the first CLI_CTM_UTTS lattices
    # the library aligns; those it skips are recorded
    gmm_host = AmGmmModel.load(tri, device="cpu")
    tm = gmm_host.tm
    lang = load_lang_dir(p("lang"))
    ctm_skipped = {}
    with TableWriter(f"ark:{p('lat_ctm.ark')}", "lat") as w:
        n_ctm = 0
        for k, v in read_table(lat_r, "lat").items():
            if n_ctm == CLI_CTM_UTTS:
                break
            try:
                lattice_to_ctm_conf(v, tm, lang, utt=k)
            except KaldiError as e:
                ctm_skipped[k] = {"error": str(e), "end_state_words": c.end_words[k]}
                continue
            w[k] = v
            n_ctm += 1
    with TableWriter(f"ark:{p('vec.ark')}", "vec") as w:
        for k in keys:
            w[k] = fmat[k].mean(0)
    with open(p("segments"), "w") as f:
        f.writelines(f"seg_{k} {k} 0.50 1.73\n" for k in keys[:8])
    with open(p("sym.map"), "w") as f:
        f.writelines(f"{w_} W{i}\n" for i, w_ in enumerate(sorted(
            {w_ for v in ref.values() for w_ in v.split()})))
    with open(p("ids.txt"), "w") as f:
        f.writelines(f"{k}\n" for k in keys[::3])
    rnn_opts = [f"--{k.replace('_', '-')}={v}" for k, v in CLI_RNNLM_OPTS.items()]

    # ---- the tools, the counts set to 0 just before them
    t_phase = time.perf_counter()
    c.zero_counts()
    c.gmm_loglikes.launches = 0
    k3_by_tool = {}
    for name, argv in (
            ("gmm-decode-faster", [*dev_opt, wt, tri, hclg, feats_r,
                                   f"ark,t:{p('gdf_words.txt')}", f"ark:{p('gdf_ali.ark')}"]),
            ("gmm-rescore-lattice", [*dev_opt, tri, lat_r, feats_r, f"ark:{p('resc.ark')}"])):
        before = c.gmm_loglikes.launches
        run(name, name, *argv)
        k3_by_tool[name] = c.gmm_loglikes.launches - before
    ali_r = f"ark:{p('gdf_ali.ark')}"
    run("lattice-to-post", "lattice-to-post", tri, few_r, f"ark:{p('post.ark')}")
    run("lattice-to-mpe-post", "lattice-to-mpe-post", f"--silence-phones={sil}", tri, ali_r,
        few_r, f"ark:{p('mpe.ark')}")
    for post in ("post", "mpe"):
        run(f"gmm-acc-stats ({post})", "gmm-acc-stats", *dev_opt, tri, feats_r,
            f"ark:{p(post + '.ark')}", p(f"{post}.acc"))
    run("rnnlm-train", "rnnlm-train", *dev_opt, *rnn_opts, f"ark:{p('rnn_text.txt')}",
        words_txt, p("cli.rnnlm"))
    run("lattice-lmrescore-rnnlm", "lattice-lmrescore-rnnlm", *dev_opt, p("cli.rnnlm"), lat_r,
        f"ark:{p('rnn.ark')}")
    ie = os.path.abspath("exp/minilib/final.ie")
    run("ivector-extract-online2", "ivector-extract-online2", *dev_opt, ie, feats_r,
        f"ark:{p('iv.ark')}")
    tensor_wall = sum(walls.values())
    # the host tools
    o = lambda n: f"ark:{p(n)}"  # noqa: E731
    run("lattice-1best", "lattice-1best", few_r, o("1best.ark"))
    run("lattice-copy", "lattice-copy", few_r, o("copy.ark"))
    run("lattice-add-penalty", "lattice-add-penalty", "--word-ins-penalty=0.5", few_r,
        o("pen.ark"))
    run("lattice-rmali", "lattice-rmali", few_r, o("rmali.ark"))
    ctm_rc, _ = run("lattice-to-ctm-conf", "lattice-to-ctm-conf", tri, p("lang"),
                    f"ark:{p('lat_ctm.ark')}", p("lat.ctm"), rcs=(0, 1))
    alw_rc, _ = run("lattice-align-words-lexicon", "lattice-align-words-lexicon", p("lang"),
                    tri, few_r, f"ark,t:{p('alw.txt')}", rcs=(0, 1))
    run("lattice-to-fst", "lattice-to-fst", few_r, o("wfst.ark"))
    for n in (4, 1):
        run(f"lattice-determinize --num-threads={n}", "lattice-determinize",
            f"--num-threads={n}", few_r, o(f"clat{n}.ark"))
    run("lattice-push", "lattice-push", o("clat4.ark"), o("push.ark"))
    run("lattice-minimize", "lattice-minimize", o("push.ark"), o("min.ark"))
    run("lattice-lmrescore", "lattice-lmrescore", f"--words={words_txt}", "--lm-scale=-1.0",
        o("clat4.ark"), p("G.arpa"), o("lmr.ark"))
    run("arpa-to-const-arpa", "arpa-to-const-arpa", p("G.arpa"), p("G.carpa"))
    run("lattice-lmrescore-pruned", "lattice-lmrescore-pruned", f"--words={words_txt}",
        "--lm-scale=0.5", o("clat4.ark"), p("G.carpa"), o("pruned.ark"))
    run("lattice-rescore-mapped", "lattice-rescore-mapped", tri, few_r, o("nnet_ll.ark"),
        o("mapped.ark"))
    run("lattice-boost-ali", "lattice-boost-ali", "--b=0.5", tri, few_r, ali_r, o("boost.ark"))
    interp_rc, _ = run("lattice-interp", "lattice-interp", few_r, o("pen.ark"), o("interp.ark"),
                       rcs=(0, 1))
    # linear lattices of the decoder's alignments, a word on each
    # non-silence phone, and a word-boundary file that makes each such
    # phone a singleton word and SIL a nonword
    alis = read_table(ali_r, "ivec")
    with open(p("wb.int"), "w") as f:
        f.writelines(f"{ph} {'nonword' if ph == sil else 'singleton'}\n"
                     for ph in sorted(set(tm.tid_to_phone_array()[1:].tolist())))
    with TableWriter(o("linear.ark"), "lat") as w:
        for k, ali in alis.items():
            lat = Lattice()
            cur = lat.start = lat.add_state(0)
            for seg in split_to_phones(tm, list(ali)):
                ph = tm.tid_to_phone(seg[0])
                for i, tid in enumerate(seg):
                    nxt = lat.add_state(lat.state_time[cur] + 1)
                    lat.arcs[cur].append(LatticeArc(int(tid), 1 + ph if i == 0 and ph != sil
                                                    else 0, 0.0, 0.0, nxt))
                    cur = nxt
            lat.finals[cur] = (0.0, 0.0)
            w[k] = lat
    run("lattice-align-words", "lattice-align-words", p("wb.int"), tri, o("linear.ark"),
        f"ark,t:{p('alb.txt')}")
    run("phone-align-lattice", "phone-align-lattice", tri, few_r, f"ark,t:{p('pal.txt')}")
    run("lattice-to-smbr-post", "lattice-to-smbr-post", f"--silence-phones={sil}", tri, ali_r,
        few_r, o("smbr.ark"))
    run("lattice-confidence", "lattice-confidence", few_r, f"ark,t:{p('conf.txt')}")
    run("copy-post", "copy-post", "--scale=0.5", o("mpe.ark"), o("cpost.ark"))
    run("scale-post", "scale-post", o("mpe.ark"), "2.0", o("spost.ark"))
    run("sum-post", "sum-post", "--scale2=0.5", o("mpe.ark"), o("smbr.ark"), o("sumpost.ark"))
    run("vector-scale", "vector-scale", "--scale=2.0", o("vec.ark"), o("vec2.ark"))
    run("vector-sum", "vector-sum", o("vec.ark"), o("vec2.ark"), o("vsum.ark"))
    run("vector-sum --sum-all", "vector-sum", "--sum-all", o("vec.ark"), p("vall.vec"))
    _, dim_out = run("feat-to-dim", "feat-to-dim", feats_r, "-")
    run("feat-to-len", "feat-to-len", feats_r, f"ark,t:{p('len.txt')}")
    run("wav-to-duration", "wav-to-duration", f"scp:{p('wav.scp')}", f"ark,t:{p('dur.txt')}")
    run("fsttablecompose", "fsttablecompose", p("small_lang", "L_disambig.fst"),
        p("small_G.fst"), p("LG.fst"))
    stoch_rc, stoch_out = run("fstisstochastic", "fstisstochastic", p("small_G.fst"),
                              rcs=(0, 1))
    subseq = 1 + max(a.ilabel for lst in VectorFst.read(open(p("LG.fst"), "rb")).arcs
                     for a in lst)
    run("fstaddsubsequentialloop", "fstaddsubsequentialloop", str(subseq), p("LG.fst"),
        p("LG_subseq.fst"))
    run("fstcomposecontext", "fstcomposecontext", f"--read-disambig-syms={p('disambig.int')}",
        p("ilabels.txt"), p("LG.fst"), p("CLG.fst"))
    run("fstrand", "fstrand", "--srand=16", "--num-states=8", "--num-arcs=14", p("rand.fst"))
    _, equiv_out = run("fstequivalent", "fstequivalent", p("rand.fst"), p("rand.fst"))
    run("make-grammar-fst", "make-grammar-fst", p("top.fst"), "1", p("sub.fst"),
        p("grammar.fst"))
    run("fstaddselfloops", "fstaddselfloops", p("loops_in.int"), p("loops_out.int"),
        p("LG.fst"), p("LG_loops.fst"))
    run("gmm-copy", "gmm-copy", tri, p("copy.mdl"))
    run("utt2spk-to-spk2utt", "utt2spk-to-spk2utt", p("data", "utt2spk"), p("data", "spk2utt"))
    run("spk2utt-to-utt2spk", "spk2utt-to-utt2spk", p("data", "spk2utt"), p("utt2spk.back"))
    _, valid_out = run("validate-data-dir", "validate-data-dir", p("data"))
    run("split-data", "split-data", p("data"), "4")
    run("subset-data-dir", "subset-data-dir", "--per-spk", p("data"), "2", p("data_sub"))
    _, tree_out = run("tree-info", "tree-info", p("tree"))
    _, am_out = run("am-info", "am-info", tri)
    _, dot = run("draw-tree", "draw-tree", p("lang", "phones.txt"), p("tree"))
    run("wav-copy", "wav-copy", f"scp:{p('wav.scp')}", o("wav_copy.ark"))
    run("est-pca", "est-pca", "--dim=20", feats_r, p("pca.mat"))
    run("modify-cmvn-stats", "modify-cmvn-stats", "0:12", o("cmvn.ark"), o("cmvn_mod.ark"))
    run("extract-feature-segments", "extract-feature-segments", feats_r, p("segments"),
        o("feat_segs.ark"))
    _, show_out = run("show-alignments", "show-alignments", p("lang", "phones.txt"), tri, ali_r)
    run("analyze-counts", "analyze-counts", ali_r, p("counts.txt"))
    run("subset-feats", "subset-feats", "--n=10", feats_r, o("sub_feats.ark"))
    run("feat-to-post", "feat-to-post", "--top-n=3", feats_r, o("fpost.ark"))
    run("sym2int", "sym2int", words_txt, p("data", "text"), p("text.int"))
    run("int2sym", "int2sym", words_txt, p("text.int"), p("text.sym"))
    run("apply-map", "apply-map", p("sym.map"), p("data", "text"), p("text.map"))
    run("filter-scp", "filter-scp", p("ids.txt"), p("wav.scp"), p("wav_some.scp"))
    _, boot_out = run("compute-wer-bootci", "compute-wer-bootci", "--replications=2000",
                      f"ark:{p('ref.txt')}", f"ark:{p('gmm_words.txt')}")
    sync()
    tools_wall = time.perf_counter() - t_phase
    launches = c.read_counts("cli_lattice")
    launches["gmm"] = c.gmm_loglikes.launches

    # ---- the library on the same inputs
    t_check = time.perf_counter()
    lats = read_table(lat_r, "lat")
    gmm = AmGmmModel.load(tri, device=dev)
    csr = read_hclg_csr(hclg, gmm.tm.tid_to_pdf_array())
    fkeys, fpad, fnf = pad_feature_batch(fmat)
    fx = torch.from_numpy(fpad).to(dev)
    ll = gmm.am.loglikes_batch(fx)
    lib = decode_batch(csr, ll, fnf, ViterbiOptions(), device=dev)
    gdf = read_table(f"ark:{p('gdf_words.txt')}", "text")
    text_of = lambda ids: " ".join(words[i] for i in ids)  # noqa: E731
    checks["gmm-decode-faster words = decode_batch"] = sum(
        gdf.get(k) == text_of(r.words) for k, r in zip(fkeys, lib))
    checks["gmm-decode-faster alignments = decode_batch"] = sum(
        np.array_equal(alis[k], r.alignment) for k, r in zip(fkeys, lib))
    checks["gmm-decode-faster words = lattice best path + end-state words"] = sum(
        gdf.get(k) == text_of(list(lattice_best_path(lats[k], 1.0, 0.1)[0]) + c.end_words[k])
        for k in fkeys)
    # gmm-rescore-lattice: the library on the same lattices and loglikes
    ll_host = ll.cpu().numpy()
    rows = {k: ll_host[i, : fnf[i]] for i, k in enumerate(fkeys)}
    resc = read_table(f"ark:{p('resc.ark')}", "lat")
    want = read_table(lat_r, "lat")
    for k in fkeys:
        rescore_lattice_acoustics(want[k], rows[k], gmm.tm.tid_to_pdf)
    checks["gmm-rescore-lattice = rescore_lattice_acoustics"] = sum(
        lattices_close(resc[k], want[k], *CLI_LAT_TOL) for k in fkeys)
    changed = sum(x.acoustic_cost != y.acoustic_cost for k in fkeys
                  for xs, ys in zip(resc[k].arcs, lats[k].arcs) for x, y in zip(xs, ys))
    # with the times recomputed, the tool's one padded launch rescores as a
    # launch per utterance does (those launches come after the counts)
    per_utt_gap, per_utt_same = 0.0, 0
    for i, k in enumerate(fkeys[:CLI_LATTICE_HOST_UTTS]):
        one = gmm.am.loglikes_batch(fx[i: i + 1, : fnf[i]])[0].cpu().numpy()
        per_utt_gap = max(per_utt_gap, float(np.abs(one - rows[k]).max()))
        a, b = read_table(lat_r, "lat")[k], lats[k]
        for lat, r in ((a, rows[k]), (b, one)):
            lattice_state_times(lat)
            rescore_lattice_acoustics(lat, r, gmm.tm.tid_to_pdf)
        per_utt_same += lattices_close(a, b, *CLI_LAT_TOL)
    checks["gmm-rescore-lattice batch rows = per-utterance launches (times recomputed)"] = \
        per_utt_same == len(fkeys[:CLI_LATTICE_HOST_UTTS])
    lats = read_table(few_r, "lat")
    # posteriors and gmm-acc-stats
    same("lattice-to-post", p("post.ark"), "post",
         ((k, lattice_to_post(lats[k], tm, 1.0, 0.1, 0.01)) for k in lats))
    post_frames = sum(len(v) for v in read_table(o("post.ark"), "post").values())
    mpe_items = []
    for k, lat in lats.items():
        if k in alis:
            mpe_items.append((k, forward_backward_mpe_variants(
                lat, tm, alis[k], criterion="mpfe", silence_phones=[sil], lm_scale=1.0,
                ac_scale=0.1)[0]))
    same("lattice-to-mpe-post", p("mpe.ark"), "post", mpe_items)
    smbr_items = [(k, forward_backward_mpe_variants(
        lats[k], tm, alis[k], criterion="smbr", silence_phones=[sil], lm_scale=1.0,
        ac_scale=0.1)[0]) for k in lats if k in alis]
    same("lattice-to-smbr-post", p("smbr.ark"), "post", smbr_items)
    acc_err = {}
    for post in ("post", "mpe"):
        posts = read_table(o(post + ".ark"), "post")
        frames, rows_, tids, wts = [], [], [], []
        n = 0
        for k in fmat:
            if k in posts and len(posts[k]) == len(fmat[k]):
                for t, fr in enumerate(posts[k]):
                    for tid, wgt in fr:
                        rows_.append(n + t)
                        tids.append(int(tid))
                        wts.append(float(wgt))
                frames.append(fmat[k])
                n += len(fmat[k])
        with open(p(f"{post}.acc"), "rb") as f:
            got, trans = read_accs(f, device=dev)
        want_trans = np.zeros(gmm.tm.num_tids + 1)
        np.add.at(want_trans, np.asarray(tids, np.int64), np.asarray(wts))
        err = {"entries": len(tids), "transition_stats_equal": bool(np.array_equal(trans,
                                                                                  want_trans))}
        for where, model in (("card", gmm), ("cpu", gmm_host)):
            accs = AccumAmDiagGmm(model.am)
            if tids:
                x = np.concatenate(frames)[np.asarray(rows_)]
                accs.accumulate_corpus(model.am, torch.from_numpy(x).to(model.am.device),
                                       gmm.tm.tid_to_pdf_array()[np.asarray(tids)],
                                       weights=np.asarray(wts))
            err[where] = max(float((getattr(got, f).cpu() - getattr(accs, f).cpu()).abs().max()
                                   / max(float(getattr(accs, f).abs().max()), 1e-300))
                             for f in ("occ", "mean_acc", "var_acc"))
        acc_err[post] = err
        checks[f"gmm-acc-stats ({post}) = accumulate_corpus"] = (
            err["transition_stats_equal"] and err["card"] <= CLI_ACC_REL
            and err["cpu"] <= CLI_ACC_REL)
    # the RNNLM: its training sentences' log-probability before and after,
    # and the rescoring card vs CPU
    rnn = load_rnnlm(p("cli.rnnlm"), device=dev)
    seqs = [[words[w_] for w_ in c.ttext[k] if w_ in words] for k in sorted(c.ttext)]
    seqs = [s_ for s_ in seqs if s_]
    init = make_rnnlm(max(words.ids()), RnnLmOptions(**CLI_RNNLM_OPTS), device="cpu")
    init.model.to(dev)
    rnn_before = float(np.mean(init.logprobs_batch(seqs)))
    rnn_after = float(np.mean(rnn.logprobs_batch(seqs)))
    checks["rnnlm-train loss falls"] = rnn_after > rnn_before
    run("lattice-lmrescore-rnnlm (cpu)", "lattice-lmrescore-rnnlm", "--device=cpu",
        p("cli.rnnlm"), rnn_cpu_r, o("rnn_cpu.ark"))
    rc_card, rc_cpu = read_table(o("rnn.ark"), "lat"), read_table(o("rnn_cpu.ark"), "lat")
    checks["lattice-lmrescore-rnnlm card = cpu"] = (
        sorted(rc_card) == keys and len(rc_cpu) == min(CLI_RNNLM_CPU_UTTS, len(keys))
        and all(lattices_close(rc_card[k], v, CLI_RNNLM_TOL, 0.0) for k, v in rc_cpu.items()))
    rnn_gap = max(abs(x.graph_cost - y.graph_cost) for k, v in rc_cpu.items()
                  for xs, ys in zip(rc_card[k].arcs, v.arcs) for x, y in zip(xs, ys))
    # iVectors: the library on the card and the CPU
    iv = read_table(o("iv.ark"), "mat")
    ivec_err = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        ext = IvectorExtractor.load(ie, device=d)
        ivec_err[where] = max(float(np.abs(iv[k] - extract_online_ivectors(
            ext, fmat[k]).cpu().numpy()).max() / np.abs(iv[k]).max()) for k in keys)
    checks["ivector-extract-online2 = extract_online_ivectors (card, cpu)"] = (
        sorted(iv) == keys and ivec_err["card"] <= CLI_IVEC_REL
        and ivec_err["cpu"] <= CLI_IVEC_CPU_REL)
    # the host lattice tools
    same("lattice-1best", p("1best.ark"), "lat",
         ((k, linear_lattice_from_path(*lattice_nbest_paths(v, 1, 1.0, 0.1)[0]))
          for k, v in lats.items()))
    checks["lattice-copy"] = data("copy.ark") == data("lat_few.ark")
    pen = read_table(few_r, "lat")
    for v in pen.values():
        for s in range(v.num_states):
            v.arcs[s] = [LatticeArc(a.ilabel, a.olabel, a.graph_cost + (0.5 if a.olabel else 0.0),
                                    a.acoustic_cost, a.nextstate) for a in v.arcs[s]]
    same("lattice-add-penalty", p("pen.ark"), "lat", pen.items())
    rm = read_table(few_r, "lat")
    for v in rm.values():
        for s in range(v.num_states):
            v.arcs[s] = [LatticeArc(0, a.olabel, a.graph_cost, a.acoustic_cost, a.nextstate)
                         for a in v.arcs[s]]
    same("lattice-rmali", p("rmali.ark"), "lat", rm.items())
    ctm_lines, ctm_failed = [], None
    for k, v in read_table(f"ark:{p('lat_ctm.ark')}", "lat").items():
        try:
            ctm_lines += [e.line() for e in lattice_to_ctm_conf(v, tm, lang, utt=k)]
        except Exception as e:  # noqa: BLE001 — the tool stops at the same lattice
            ctm_failed = f"{k}: {e}"
            break
    with open(p("lat.ctm")) as f:
        checks["lattice-to-ctm-conf"] = bool(f.read().splitlines() == ctm_lines and ctm_lines
                                              and ctm_rc == (1 if ctm_failed else 0))
    alw, alw_failed = [], 0
    for k, v in lats.items():
        ws, tids_, _ = lattice_best_path(v, 1.0, 0.1)
        try:
            alw.append((k, " ; ".join(f"{a} {b} {n_}" for a, b, n_ in
                                      align_words_lexicon(tm, lang, ws, tids_))))
        except Exception:  # noqa: BLE001 — counted, as the tool counts it
            alw_failed += 1
    same("lattice-align-words-lexicon", p("alw.txt"), "text", alw)
    checks["lattice-align-words-lexicon"] &= alw_rc == (0 if alw or not alw_failed else 1)
    same("lattice-to-fst", p("wfst.ark"), "fst",
         ((k, lattice_to_word_fst(v, 1.0, 0.0)) for k, v in lats.items()))
    checks["lattice-determinize 4 threads = 1 thread"] = data("clat4.ark") == data("clat1.ark")
    same("lattice-determinize", p("clat1.ark"), "clat",
         ((k, determinize_lattice(v)) for k, v in lats.items()))
    clats = read_table(o("clat4.ark"), "clat")
    same("lattice-push", p("push.ark"), "clat",
         ((k, push_compact_lattice(v)) for k, v in clats.items()))
    same("lattice-minimize", p("min.ark"), "clat",
         ((k, minimize_compact_lattice(v)) for k, v in read_table(o("push.ark"),
                                                                    "clat").items()))
    lm = load_lm(p("G.arpa"))
    same("lattice-lmrescore", p("lmr.ark"), "clat",
         ((k, lmrescore_compact_lattice(v, words, lm, new_scale=-1.0)) for k, v in clats.items()))
    checks["arpa-to-const-arpa"] = load_lm(p("G.carpa")).ngrams == lm.ngrams
    same("lattice-lmrescore-pruned", p("pruned.ark"), "clat",
         ((k, compose_lattice_pruned(v, words, lm, new_scale=0.5, lattice_beam=6.0,
                                     max_arcs=200000)) for k, v in clats.items()))
    nll = read_table(o("nnet_ll.ark"), "mat")
    mapped = read_table(few_r, "lat")
    for k, v in mapped.items():
        rescore_lattice_acoustics(v, nll[k], tm.tid_to_pdf)
    same("lattice-rescore-mapped", p("mapped.ark"), "lat", mapped.items())
    checks["lattice-boost-ali (unchanged: state times)"] = (data("boost.ark")
                                                           == data("lat_few.ark"))
    pen = read_table(o("pen.ark"), "lat")
    interp = [(k, lattice_interp(v, pen[k], alpha=0.5)) for k, v in lats.items() if k in pen]
    same("lattice-interp", p("interp.ark"), "lat", [(k, v) for k, v in interp if v is not None])
    checks["lattice-interp"] &= interp_rc == (0 if any(v is not None for _, v in interp) else 1)
    boundary = {int(a): b for a, b in (ln.split() for ln in open(p("wb.int")))}
    same("lattice-align-words", p("alb.txt"), "text",
         ((k, " ; ".join(f"{a} {b} {n_}" for a, b, n_ in align_words_boundary(
             tm, boundary, *lattice_best_path(v, 1.0, 0.1)[:2])))
          for k, v in read_table(o("linear.ark"), "lat").items()))
    pal = []
    for k, v in lats.items():
        t, segs = 0, []
        for seg in split_to_phones(tm, list(lattice_best_path(v, 1.0, 0.1)[1])):
            segs.append(f"{tm.tid_to_phone(seg[0])} {t} {len(seg)}")
            t += len(seg)
        pal.append((k, " ; ".join(segs)))
    same("phone-align-lattice", p("pal.txt"), "text", pal)
    conf = read_table(f"ark:{p('conf.txt')}", "flt")
    checks["lattice-confidence"] = sorted(conf) == sorted(lats) and all(
        0.0 <= v <= 1e10 for v in conf.values())
    mpe = read_table(o("mpe.ark"), "post")
    same("copy-post", p("cpost.ark"), "post", ((k, scale_post(v, 0.5)) for k, v in mpe.items()))
    same("scale-post", p("spost.ark"), "post", ((k, scale_post(v, 2.0)) for k, v in mpe.items()))
    smbr = read_table(o("smbr.ark"), "post")
    sums = []
    for k, v in mpe.items():
        frames_ = []
        for f1, f2 in zip(v, smbr[k]):
            d = {}
            for i, x in f1:
                d[i] = d.get(i, 0.0) + x
            for i, x in f2:
                d[i] = d.get(i, 0.0) + 0.5 * x
            frames_.append(sorted(d.items()))
        sums.append((k, frames_))
    same("sum-post", p("sumpost.ark"), "post", sums)
    vec = read_table(o("vec.ark"), "vec")
    same("vector-scale", p("vec2.ark"), "vec", ((k, v * 2.0) for k, v in vec.items()))
    vec2 = read_table(o("vec2.ark"), "vec")
    same("vector-sum", p("vsum.ark"), "vec",
         ((k, (np.asarray(v, np.float64) + vec2[k]).astype(np.float32)) for k, v in vec.items()))
    with open(p("vall.vec"), "rb") as f:
        init_kaldi_input_stream(f)
        vall = read_vector(f)
    checks["vector-sum --sum-all"] = np.allclose(
        vall, np.sum([np.asarray(v, np.float64) for v in vec.values()], 0), rtol=1e-6)
    checks["feat-to-dim"] = dim_out.strip() == str(fmat[keys[0]].shape[1])
    checks["feat-to-len"] = read_table(f"ark:{p('len.txt')}", "text") == {
        k: str(len(v)) for k, v in fmat.items()}
    waves = read_table(f"scp:{p('wav.scp')}", "wav")
    checks["wav-to-duration"] = read_table(f"ark:{p('dur.txt')}", "text") == {
        k: f"{v.data.shape[1] / v.samp_freq:.5g}" for k, v in waves.items()}
    checks["wav-copy"] = all(np.array_equal(v.data, waves[k].data) for k, v in
                             read_table(o("wav_copy.ark"), "wav").items())

    def fst_bytes(fst):
        buf = io.BytesIO()
        fst.write(buf)
        return buf.getvalue()

    L = VectorFst.read(open(p("small_lang", "L_disambig.fst"), "rb"))
    LG = falg.compose(L, VectorFst.read(open(p("small_G.fst"), "rb")))
    checks["fsttablecompose"] = data("LG.fst") == fst_bytes(LG)
    checks["fstaddsubsequentialloop"] = data("LG_subseq.fst") == fst_bytes(
        add_subsequential_loop(LG, subseq))
    clg, info = compose_context(LG, 3, 1, small_disambig, subseq)
    with open(p("ilabels.txt")) as f:
        checks["fstcomposecontext"] = (data("CLG.fst") == fst_bytes(clg) and f.read().splitlines()
                                       == [" ".join(map(str, i)) for i in info])
    rfst = rand_fst(random.Random(16), 8, 14, 3, 3)
    checks["fstrand"] = data("rand.fst") == fst_bytes(rfst)
    checks["fstequivalent"] = equiv_out.strip() == "equivalent"
    checks["make-grammar-fst"] = data("grammar.fst") == fst_bytes(falg.replace_fst(
        linear_fst([2, 1, 3]), {1: linear_fst([4, 5])}))
    falg.add_disambig_self_loops(LG, [(small_disambig[0], 0)])
    checks["fstaddselfloops"] = data("LG_loops.fst") == fst_bytes(LG)
    checks["fstisstochastic"] = len(stoch_out.split()) == 2
    a, b = AmGmmModel.load(p("copy.mdl"), device="cpu"), gmm_host
    checks["gmm-copy"] = all(
        np.array_equal(x.means, y.means) and np.array_equal(x.vars, y.vars)
        and np.array_equal(x.weights, y.weights) for x, y in zip(a.am.pdfs, b.am.pdfs))
    with open(p("data", "utt2spk")) as f, open(p("utt2spk.back")) as g:
        checks["utt2spk-to-spk2utt / spk2utt-to-utt2spk"] = sorted(f) == sorted(g)
    checks["validate-data-dir"] = valid_out.strip() == f"validate-data-dir: OK ({len(keys)} utterances)"
    shards = [open(p("data", "split4", str(i), "utt2spk")).read().split("\n")[:-1]
              for i in range(1, 5)]
    checks["split-data"] = sorted(ln.split()[0] for s_ in shards for ln in s_) == keys
    per_spk = {}
    for i, k in enumerate(keys):
        per_spk[i % 8] = per_spk.get(i % 8, 0) + 1
    checks["subset-data-dir"] = len(open(p("data_sub", "utt2spk")).readlines()) == sum(
        min(2, n_) for n_ in per_spk.values())
    checks["tree-info"] = tree_out.splitlines()[0] == "num-pdfs 2000"
    checks["am-info"] = f"number of pdfs {gmm.am.num_pdfs}" in am_out
    checks["draw-tree"] = dot.startswith("digraph tree {") and dot.count("pdf ") >= 2000
    with open(p("pca.mat"), "rb") as f:
        init_kaldi_input_stream(f)
        pca = read_matrix(f)
    xs = np.concatenate([fmat[k] for k in fmat]).astype(np.float64)
    mean = xs.mean(0)
    ev, evec = np.linalg.eigh(xs.T @ xs / len(xs) - np.outer(mean, mean))
    top = evec[:, ::-1][:, :20].T
    signs = np.sign((pca[:, :-1] * top).sum(1))[:, None]
    checks["est-pca (up to sign)"] = bool(np.abs(pca[:, :-1] * signs - top).max() < 1e-4)
    cm = read_table(o("cmvn.ark"), "mat")
    mod = read_table(o("cmvn_mod.ark"), "mat")
    checks["modify-cmvn-stats"] = all(
        mod[k][0, 0] == 0 and mod[k][0, 12] == 0 and mod[k][1, 0] == cm[k][0, -1]
        and np.array_equal(mod[k][:, 1:12], cm[k][:, 1:12]) for k in cm)
    segs = read_table(o("feat_segs.ark"), "mat")
    checks["extract-feature-segments"] = all(
        np.array_equal(segs[f"seg_{k}"], fmat[k][50:173]) for k in keys[:8])
    checks["show-alignments"] = len(show_out.splitlines()) == len(alis)
    counts = np.bincount(np.concatenate(list(alis.values())))
    with open(p("counts.txt")) as f:
        checks["analyze-counts"] = [int(x) for x in f.read().split()[1:-1]] == counts.tolist()
    checks["subset-feats"] = sorted(read_table(o("sub_feats.ark"), "mat")) == keys[:10]
    fpost = read_table(o("fpost.ark"), "post")
    k0 = keys[0]
    checks["feat-to-post"] = all(
        sorted(i for i, _ in fr) == sorted(np.argsort(-fmat[k0][t])[:3].tolist())
        for t, fr in enumerate(fpost[k0]))
    with open(p("text.sym")) as f, open(p("data", "text")) as g:
        checks["sym2int / int2sym"] = f.read() == g.read()
    with open(p("text.map")) as f:
        checks["apply-map"] = len(f.readlines()) == len(keys)
    with open(p("wav_some.scp")) as f:
        checks["filter-scp"] = [ln.split()[0] for ln in f] == keys[::3]
    stats = compute_wer({k: ref[k].split() for k in keys},
                        {k: v.split() for k, v in read_table(
                            f"ark:{p('gmm_words.txt')}", "text").items()})
    checks["compute-wer-bootci"] = f"WER {stats.wer:.2f} " in boot_out
    check_seconds = time.perf_counter() - t_check
    # K3 at the phase's batch, against its plain version
    k3 = {}
    if on_card:
        k3["cli_lattice_features"] = c.k3_at(torch, c.gmm_loglikes, c.gmm_loglikes_plain,
                                             gmm.am.weights(),
                                             fx.reshape(-1, fx.shape[-1]).contiguous(), c.plug)
    del fx, ll
    bad = {k: v for k, v in checks.items()
           if v is not True and not (isinstance(v, (int, np.integer)) and not isinstance(v, bool)
                                     and v == len(keys))}
    tools_run = {label.split(" ")[0] for label in walls}
    batch = {n for n, fn in tools.TOOLS.items()
             if fn.__module__.rsplit(".", 1)[-1] in ("lat_tools", "util_tools")}
    c.emit({"phase": "cli_lattice", "card": c.card, "utterances": len(keys),
            "tools": len(tools_run & batch), "tools_wall_seconds": tools_wall,
            "tensor_tools_wall_seconds": tensor_wall, "check_seconds": check_seconds,
            "phase_seconds": time.perf_counter() - t_start, "tool_seconds": walls,
            "launches": {k: launches[k] for k in ("gather", "mfcc", "gmm")},
            "gmm_launches_by_tool": k3_by_tool,
            "checks": {k: (bool(v) if isinstance(v, (bool, np.bool_)) else int(v))
                       for k, v in checks.items()},
            "rescore_arcs_changed": changed, "rescore_batch_vs_per_utterance_max_abs": per_utt_gap,
            "lattice_to_post_frames": post_frames, "acc_stats": acc_err,
            "rnnlm": {"options": CLI_RNNLM_OPTS, "sentences": len(seqs),
                      "train_logprob_before": rnn_before, "train_logprob_after": rnn_after,
                      "rescore_card_vs_cpu_max_abs": rnn_gap},
            "ivector_max_rel_err": ivec_err, "ctm_lines": len(ctm_lines),
            "ctm_lattices_skipped": ctm_skipped,
            "align_words_lexicon_failed": alw_failed, "fstisstochastic": stoch_out.strip(),
            "compute_wer_bootci": boot_out.strip().splitlines()[-1], "gmm_at_cli_lattice_shapes": k3})
    if bad:
        faults.append(f"cli_lattice: checks failed: {sorted(bad)}")
    if tools_run != batch or len(batch) != 66:
        faults.append(f"cli_lattice: tools not run: {sorted(batch - tools_run)}")
    if on_card and (launches["gmm"] == 0 or min(k3_by_tool.values()) == 0):
        faults.append(f"cli_lattice: the GMM kernel was not launched by each scoring tool: "
                      f"{k3_by_tool}")
    if on_card and tensor_wall > 40.0:
        faults.append(f"cli_lattice: the tensor tools took {tensor_wall:.1f} s (aim 40)")
    return {"faults": faults, "launches": launches, "k3": k3}


CLI_TRAIN_LEAVES = 200  # build-tree's --max-leaves on the 64 training utterances
CLI_TRAIN_MIXUP = 300  # gmm-mixup's total after gmm-init-model
CLI_TRAIN_MIX = (400, 500)  # gmm-est --mix-up of the two EM iterations
CLI_TRAIN_REL = 1e-9  # tool vs library: float64 statistics and models, of max|ref|
CLI_TRAIN_SPEAKERS = 8  # speakers of the 64 training and of the 64 held-out utterances
CLI_TRAIN_LDA_DIM = 30
CLI_TRAIN_UBM = 64  # Gaussians of the fMPE offset GMM
CLI_TRAIN_REGTREE = 32  # gmm-make-regtree's baseclasses
CLI_TRAIN_MIN_COUNT = 200.0  # gmm-est-fmllr{,-gpost}'s --fmllr-min-count (SAT)
CLI_TRAIN_REGTREE_MIN_COUNT = 1000.0  # the regtree tools' --min-count (their default)
# the tools of bin/train_tools.py that take --device (the phase passes
# --device=cpu to them when it is rehearsed on the CPU)
CLI_TRAIN_TENSOR_TOOLS = frozenset((
    "gmm-align-compiled", "gmm-acc-stats-ali", "gmm-est", "gmm-compute-likes", "acc-lda",
    "gmm-acc-mllt", "gmm-est-fmllr", "gmm-post-to-gpost", "gmm-est-fmllr-gpost",
    "gmm-basis-fmllr-training", "gmm-est-basis-fmllr", "gmm-train-lvtln-special",
    "gmm-est-lvtln-trans", "gmm-est-regtree-fmllr", "gmm-est-regtree-mllr",
    "gmm-decode-faster-regtree-fmllr", "gmm-decode-faster-regtree-mllr",
    "gmm-get-stats-deriv", "gmm-fmpe-acc-stats", "fmpe-apply-transform"))


def cli_train(torch, np, c) -> dict:
    """The cli_train phase: the rest of bin/train_tools.py (54 tools) in-process
    through bin.tools.main, on the cli phase's work directory (its 64
    training utterances' features, transcripts and tri.mdl alignments, its
    64 held-out utterances' features and tri.mdl lattices, HCLG, lang dir
    and tree), as the Kaldi recipes run them: train_deltas.sh (tree
    statistics of two halves summed, questions, a 200-leaf tree, the model,
    mix-up, converted alignments, training graphs, two EM iterations of
    alignment, statistics, sum and re-estimation), train_lda_mllt.sh and
    train_sat.sh (LDA, MLLT in the LDA space, fMLLR per speaker, the
    Gaussian-posterior path), adaptation on the held-out set with tri.mdl
    (regression tree, MLLR and fMLLR per speaker from the best paths of
    gmm-latgen-faster, the two regtree decoders on the HCLG, basis fMLLR,
    linear VTLN) and fMPE (MPE posteriors of the lattices, an offset GMM of
    64 Gaussians made by the library).  The kernels' counts are set to 0
    just before the tools run and read just after; each tool is then held to
    the port's library on the same inputs (files byte for byte, float64
    statistics and models within CLI_TRAIN_REL of each array's largest
    magnitude, decoded words equal)."""
    import contextlib
    import io

    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.bin.train_tools import (
        _Corpus, _read_mat, _write_mat, read_arrays, regtree_loglikes)
    from old_kaldi_git_tpu_torch.decoder.csr import fst_to_csr_native
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import (
        ViterbiOptions, align_batch, align_shape, decode_batch)
    from old_kaldi_git_tpu_torch.fst.native import NativeFst
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel, DiagGmm
    from old_kaldi_git_tpu_torch.gmm.mle import (
        AccumAmDiagGmm, init_am_from_tree_stats, mixup, mle_am_diag_gmm_update, read_accs)
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import convert_alignment
    from old_kaldi_git_tpu_torch.hmm.posterior import ali_to_post, weight_silence_post
    from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
    from old_kaldi_git_tpu_torch.transform import basis_fmllr, fmpe, lvtln, regtree
    from old_kaldi_git_tpu_torch.transform.fmllr import FmllrAccs, compute_fmllr_transforms
    from old_kaldi_git_tpu_torch.transform.lda import LdaEstimate
    from old_kaldi_git_tpu_torch.transform.mllt import MlltAccs, update_mllt
    from old_kaldi_git_tpu_torch.tree.build_tree import (
        accumulate_tree_stats, build_tree, cluster_phones_into_questions, read_tree_stats,
        sum_tree_stats, write_tree_stats)
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

    t_start = time.perf_counter()
    dev, wd = c.dev, c.workdir
    on_card = dev.type == "cuda"
    p = lambda *a: os.path.join(wd, *a)  # noqa: E731
    o = lambda n: f"ark:{p(n)}"  # noqa: E731
    tri = c.tri
    faults, walls, checks, gaps = [], {}, {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(label, *argv, rcs=(0,)):
        """A tool in-process (--device=cpu added to a tensor tool off the
        card): what it printed; its wall under `label`, ended by a device
        synchronise."""
        argv = list(argv)
        if not on_card and argv[0] in CLI_TRAIN_TENSOR_TOOLS:
            argv.insert(1, "--device=cpu")
        out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tools.main(argv)
        sync()
        walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
        if rc not in rcs:
            raise RuntimeError(f"cli_train: {label} exited {rc}")
        out.flush()
        return out.buffer.getvalue().decode()

    def data(name):
        with open(name if os.path.isabs(name) else p(name), "rb") as f:
            return f.read()

    def as_bytes(write, *a):
        buf = io.BytesIO()
        write(buf, *a)
        return buf.getvalue()

    def gap(name, got, want):
        """|got − want| over max|want| (arrays or tensors), kept under `name`."""
        got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
        want = want.detach().cpu().numpy() if hasattr(want, "detach") else np.asarray(want)
        g = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)) \
            if got.shape == want.shape else float("inf")
        gaps[name] = max(gaps.get(name, 0.0), g)
        return g

    def same_archive(name, path, holder, items):
        want = p(f"want_{name}")
        with TableWriter(f"ark:{want}", holder) as w:
            for k, v in items:
                w[k] = v
        checks[name] = data(path) == data(want)

    def same_file(name, path, save):
        """The tool's file byte for byte the library's, written by `save(path)`."""
        save(p(f"want_{name}"))
        checks[name] = data(path) == data(f"want_{name}")

    # ---- inputs, before the counts start (host work and the library's UBM)
    tri_host = AmGmmModel.load(tri, device="cpu")
    tm = tri_host.tm
    sil = str(int(c.sil[0]))
    tfeats = read_table(o("train_feats.ark"), "mat")
    tkeys = sorted(tfeats)
    hfeats = read_table(o("feats.ark"), "mat")
    hkeys = sorted(hfeats)
    tali = read_table(o("gmm-align-compiled.ark"), "ivec")
    for name, keys in (("train", tkeys), ("test", hkeys)):
        with open(p(f"{name}_spk2utt"), "w") as f:
            for s in range(min(CLI_TRAIN_SPEAKERS, len(keys))):
                f.write(f"spk{s} " + " ".join(keys[s::CLI_TRAIN_SPEAKERS]) + "\n")
        with open(p(f"{name}_utt2spk"), "w") as f:
            f.writelines(f"{k} spk{i % CLI_TRAIN_SPEAKERS}\n" for i, k in enumerate(keys))
    halves = (tkeys[: len(tkeys) // 2], tkeys[len(tkeys) // 2:])
    for i, ks in enumerate(halves):
        with TableWriter(o(f"tr_feats{i}.ark"), "mat") as w:
            for k in ks:
                w[k] = tfeats[k]
    rng = np.random.default_rng(17)
    warp = np.eye(tfeats[tkeys[0]].shape[1]) + 0.05 * rng.standard_normal(
        (tfeats[tkeys[0]].shape[1],) * 2)
    with TableWriter(o("tr_warped.ark"), "mat") as w:
        for k in tkeys:
            w[k] = (tfeats[k].astype(np.float64) @ warp.T).astype(np.float32)
    xs = np.concatenate([tfeats[k] for k in tkeys]).astype(np.float64)
    pick = rng.choice(len(xs), CLI_TRAIN_UBM, replace=False)
    DiagGmm(np.full(CLI_TRAIN_UBM, 1.0 / CLI_TRAIN_UBM), xs[pick],
            np.tile(xs.var(0), (CLI_TRAIN_UBM, 1))).save(p("ubm"))
    from old_kaldi_git_tpu_torch.utils.io_funcs import init_kaldi_output_stream, write_matrix
    for i in range(2):
        with open(p(f"m{i}.mat"), "wb") as f:
            init_kaldi_output_stream(f, True)
            write_matrix(f, rng.standard_normal((5, 6)))
    with open(p("ilabels_h.txt"), "w") as f:
        f.write("\n-42\n0 2 3\n2 3 4\n3 4 0\n0\n")
    with open(p("ilabels_nd.txt"), "w") as f:
        f.write("\n0 2 3\n2 3 4\n3 4 0\n")
    hhalves = (hkeys[: len(hkeys) // 2], hkeys[len(hkeys) // 2:])
    for i, ks in enumerate(hhalves):
        with TableWriter(o(f"te_feats{i}.ark"), "mat") as w:
            for k in ks:
                w[k] = hfeats[k]
    phones = ":".join(str(x) for x in tm.topo.phones)
    dev_tools = {}  # K3 / K1 launches by tool

    def counted(label, *argv):
        g0, k0 = c.gmm_loglikes.launches, c.batched_table_gather.launches
        out = run(label, *argv)
        dev_tools[label] = {"gmm": c.gmm_loglikes.launches - g0,
                            "gather": c.batched_table_gather.launches - k0}
        return out

    # ---- the tools, the counts set to 0 just before them
    t_phase = time.perf_counter()
    c.zero_counts()
    c.gmm_loglikes.launches = 0
    # train_deltas.sh: tree statistics (two halves, summed), questions, tree
    for i in range(2):
        run("acc-tree-stats", "acc-tree-stats", tri, o(f"tr_feats{i}.ark"),
            o("gmm-align-compiled.ark"), p(f"tree{i}.stats"))
    run("sum-tree-stats", "sum-tree-stats", p("tree.stats"), p("tree0.stats"), p("tree1.stats"))
    run("cluster-phones", "cluster-phones", p("tree.stats"), phones, p("questions.txt"))
    run("compile-questions", "compile-questions", tri, p("questions.txt"), p("questions.qst"))
    run("build-tree", "build-tree", f"--max-leaves={CLI_TRAIN_LEAVES}",
        f"--questions={p('questions.qst')}", p("tree.stats"), tri, p("tree2"))
    run("build-tree-two-level", "build-tree-two-level", f"--max-leaves-second={CLI_TRAIN_LEAVES}",
        "--max-leaves-first=40", f"--questions={p('questions.qst')}", p("tree.stats"), tri,
        p("tree2b"), p("tree2b.map"))
    run("gmm-init-model", "gmm-init-model", p("tree2"), p("tree.stats"), tri, p("1.mdl"))
    run("gmm-mixup", "gmm-mixup", f"--mix-up={CLI_TRAIN_MIXUP}", p("1.mdl"), p("1m.mdl"))
    run("convert-ali", "convert-ali", tri, p("1m.mdl"), p("tree2"), o("gmm-align-compiled.ark"),
        o("ali_conv.ark"))
    run("compile-train-graphs", "compile-train-graphs", p("tree2"), p("1m.mdl"), p("lang"),
        f"ark,t:{p('train_text.txt')}", o("graphs2.ark"))
    mdl = p("1m.mdl")
    for it, mix in enumerate(CLI_TRAIN_MIX):
        counted(f"gmm-align-compiled (iteration {it + 1})", "gmm-align-compiled", mdl,
                o("graphs2.ark"), o("train_feats.ark"), o(f"ali{it}.ark"))
        for i in range(2):
            run("gmm-acc-stats-ali", "gmm-acc-stats-ali", mdl, o(f"tr_feats{i}.ark"),
                o(f"ali{it}.ark"), p(f"{it}.{i}.acc"))
        run("gmm-sum-accs", "gmm-sum-accs", p(f"{it}.acc"), p(f"{it}.0.acc"), p(f"{it}.1.acc"))
        run("gmm-est", "gmm-est", f"--mix-up={mix}", mdl, p(f"{it}.acc"), p(f"{it + 2}.mdl"))
        mdl = p(f"{it + 2}.mdl")
    counted("gmm-compute-likes", "gmm-compute-likes", mdl, o("train_feats.ark"), o("likes.ark"))
    run("gmm-boost-silence", "gmm-boost-silence", "--boost=1.2", sil, mdl, p("boost.mdl"))
    run("gmm-init-mono", "gmm-init-mono", p("lang"), o("train_feats.ark"), p("mono0.mdl"),
        p("mono0.tree"))
    # posteriors and train_lda_mllt.sh / train_sat.sh
    last_ali = o(f"ali{len(CLI_TRAIN_MIX) - 1}.ark")
    run("ali-to-pdf", "ali-to-pdf", mdl, last_ali, o("pdf.ark"))
    run("ali-to-post", "ali-to-post", last_ali, o("post.ark"))
    run("weight-silence-post", "weight-silence-post", "0.0", sil, mdl, o("post.ark"),
        o("wpost.ark"))
    run("post-to-pdf-post", "post-to-pdf-post", mdl, o("wpost.ark"), o("pdfpost.ark"))
    run("post-to-weights", "post-to-weights", o("wpost.ark"), o("weights.ark"))
    run("acc-lda", "acc-lda", mdl, o("train_feats.ark"), o("wpost.ark"), p("lda.acc"))
    run("est-lda", "est-lda", f"--dim={CLI_TRAIN_LDA_DIM}", p("lda.acc"), p("lda.mat"))
    run("transform-feats", "transform-feats", p("lda.mat"), o("train_feats.ark"), o("lda.ark"))
    run("acc-tree-stats", "acc-tree-stats", mdl, o("lda.ark"), last_ali, p("lda.stats"))
    run("gmm-init-model", "gmm-init-model", p("tree2"), p("lda.stats"), mdl, p("lda0.mdl"))
    run("gmm-acc-mllt", "gmm-acc-mllt", p("lda0.mdl"), o("lda.ark"), o("wpost.ark"), p("mllt.acc"))
    run("est-mllt", "est-mllt", p("mllt.acc"), p("mllt.mat"))
    run("gmm-transform-means", "gmm-transform-means", p("mllt.mat"), p("lda0.mdl"), p("mllt.mdl"))
    run("compose-transforms", "compose-transforms", p("mllt.mat"), p("lda.mat"),
        p("ldamllt.mat"))
    run("transform-feats", "transform-feats", p("ldamllt.mat"), o("train_feats.ark"),
        o("ldamllt.ark"))
    spk_t = f"--spk2utt={p('train_spk2utt')}"
    mc = f"--fmllr-min-count={CLI_TRAIN_MIN_COUNT}"
    run("gmm-est-fmllr", "gmm-est-fmllr", spk_t, mc, p("mllt.mdl"), o("ldamllt.ark"),
        o("wpost.ark"), o("fmllr.ark"))
    run("transform-feats", "transform-feats", f"--utt2spk={p('train_utt2spk')}", o("fmllr.ark"),
        o("ldamllt.ark"), o("sat.ark"))
    run("gmm-post-to-gpost", "gmm-post-to-gpost", p("mllt.mdl"), o("ldamllt.ark"),
        o("wpost.ark"), o("gpost.ark"))
    run("gmm-est-fmllr-gpost", "gmm-est-fmllr-gpost", spk_t, mc, p("mllt.mdl"), o("ldamllt.ark"),
        o("gpost.ark"), o("gfmllr.ark"))
    # adaptation with tri.mdl: its training alignments as silence-weighted
    # posteriors, the best paths of the cli phase's held-out lattices as
    # posteriors (adapting from silence-free statistics gives the silence
    # Gaussians a speech node's transform)
    run("ali-to-post", "ali-to-post", o("gmm-align-compiled.ark"), o("tri_post.ark"))
    run("weight-silence-post", "weight-silence-post", "0.0", sil, tri, o("tri_post.ark"),
        o("tri_wpost.ark"))
    run("lattice-best-path", "lattice-best-path", "--acoustic-scale=0.1", o("lat.ark"),
        o("bp_w.txt"), o("bp_ali.ark"))
    run("ali-to-post", "ali-to-post", o("bp_ali.ark"), o("bp_post.ark"))
    spk_h = f"--spk2utt={p('test_spk2utt')}"
    mcr = f"--min-count={CLI_TRAIN_REGTREE_MIN_COUNT}"
    run("gmm-make-regtree", "gmm-make-regtree", f"--max-leaves={CLI_TRAIN_REGTREE}", tri,
        p("regtree"))
    for kind in ("mllr", "fmllr"):
        run(f"gmm-est-regtree-{kind}", f"gmm-est-regtree-{kind}", spk_h, mcr, tri, p("regtree"),
            o("feats.ark"), o("bp_post.ark"), o(f"{kind}.regx"))
        counted(f"gmm-decode-faster-regtree-{kind}", f"gmm-decode-faster-regtree-{kind}",
                f"--utt2spk={p('test_utt2spk')}", tri, p("regtree"),
                p("graph", "HCLG.fst"), o("feats.ark"), o(f"{kind}.regx"),
                f"ark,t:{p(kind + '_words.txt')}", o(f"{kind}_ali.ark"))
    run("gmm-basis-fmllr-training", "gmm-basis-fmllr-training", spk_t, "--num-bases=40", tri,
        o("train_feats.ark"), o("tri_wpost.ark"), p("fmllr.basis"))
    run("gmm-est-basis-fmllr", "gmm-est-basis-fmllr", spk_h, tri, p("fmllr.basis"),
        o("feats.ark"), o("bp_post.ark"), o("basis_fmllr.ark"))
    dim = tfeats[tkeys[0]].shape[1]
    run("gmm-init-lvtln", "gmm-init-lvtln", f"--dim={dim}", "--num-classes=3",
        "--min-warp=0.9", "--max-warp=1.1", p("0.lvtln"))
    run("gmm-train-lvtln-special", "gmm-train-lvtln-special", "0", p("0.lvtln"), p("1.lvtln"),
        o("train_feats.ark"), o("tr_warped.ark"))
    run("gmm-est-lvtln-trans", "gmm-est-lvtln-trans", spk_h, tri, p("1.lvtln"), o("feats.ark"),
        o("bp_post.ark"), o("lvtln.ark"), f"ark,t:{p('warps.txt')}")
    # fMPE on the held-out set: MPE posteriors of the lattices
    run("lattice-to-mpe-post", "lattice-to-mpe-post", f"--silence-phones={sil}", tri,
        o("bp_ali.ark"), o("lat.ark"), o("mpe.ark"))
    run("fmpe-init", "fmpe-init", p("ubm"), p("0.fmpe"))
    run("gmm-get-stats-deriv", "gmm-get-stats-deriv", tri, p("0.fmpe"), o("feats.ark"),
        o("mpe.ark"), o("bp_ali.ark"), p("deriv.stats"))
    for i in range(2):
        run("gmm-fmpe-acc-stats", "gmm-fmpe-acc-stats", f"--model-derivs={p('deriv.stats')}",
            f"--ali={o('bp_ali.ark')}", tri, p("0.fmpe"), o(f"te_feats{i}.ark"), o("mpe.ark"),
            p(f"fmpe{i}.acc"))
    run("fmpe-sum-accs", "fmpe-sum-accs", p("fmpe.acc"), p("fmpe0.acc"), p("fmpe1.acc"))
    run("fmpe-est", "fmpe-est", "--learning-rate=0.1", p("0.fmpe"), p("fmpe.acc"), p("1.fmpe"))
    run("fmpe-apply-transform", "fmpe-apply-transform", p("1.fmpe"), o("feats.ark"),
        o("fmpe_feats.ark"))
    # the utilities
    run("copy-matrix", "copy-matrix", "--scale=0.5", o("lda.ark"), o("copy_mat.ark"))
    run("copy-vector", "copy-vector", "--scale=2", o("weights.ark"), o("copy_vec.ark"))
    run("copy-int-vector", "copy-int-vector", last_ali, o("copy_ali.ark"))
    run("sum-matrices", "sum-matrices", p("sum.mat"), p("m0.mat"), p("m1.mat"))
    show = run("show-transitions", "show-transitions", p("lang", "phones.txt"), mdl)
    run("align-text", "align-text", f"ark:{p('ref.txt')}", f"ark:{p('mllr_words.txt')}",
        f"ark,t:{p('align.txt')}")
    run("make-h-transducer", "make-h-transducer", p("ilabels_h.txt"), p("tree2"), mdl, p("Ha.fst"))
    run("make-h-transducer", "make-h-transducer", p("ilabels_nd.txt"), p("tree2"), mdl,
        p("Ha_nd.fst"))
    run("add-self-loops", "add-self-loops", mdl, p("Ha_nd.fst"), p("Ha_loops.fst"))
    sync()
    tools_wall = time.perf_counter() - t_phase
    launches = c.read_counts("cli_train")
    launches["gmm"] = c.gmm_loglikes.launches

    # ---- the library on the same inputs
    t_check = time.perf_counter()
    # trees
    lib_half = []
    for i, ks in enumerate(halves):
        st = {}
        for k in ks:
            accumulate_tree_stats(tali[k], tfeats[k], tm, stats=st)
        lib_half.append(st)
        checks[f"acc-tree-stats (half {i})"] = data(f"tree{i}.stats") == as_bytes(
            write_tree_stats, st)
    stats = sum_tree_stats(sum_tree_stats({}, lib_half[0]), lib_half[1])
    checks["sum-tree-stats"] = data("tree.stats") == as_bytes(write_tree_stats, stats)
    with open(p("tree.stats"), "rb") as f:
        stats = read_tree_stats(f)
    topo = tm.topo
    npc = {ph: topo.num_pdf_classes(ph) for ph in topo.phones}
    qs = cluster_phones_into_questions(stats, list(topo.phones), P=1)
    checks["cluster-phones"] = data("questions.txt").decode() == "".join(
        " ".join(str(x) for x in sorted(q)) + "\n" for q in qs)
    inventory, seen, cq = set(topo.phones), set(), []
    for q in qs:
        q = sorted(set(q) & inventory)
        if q and tuple(q) not in seen:
            seen.add(tuple(q))
            cq.append(q)
    if tuple(sorted(inventory)) not in seen:
        cq.append(sorted(inventory))
    checks["compile-questions"] = data("questions.qst").decode() == "".join(
        " ".join(map(str, q)) + "\n" for q in cq)
    ctx2 = build_tree(stats, topo.phones, npc, questions=[set(q) for q in cq],
                      max_leaves=CLI_TRAIN_LEAVES, thresh=20.0)
    checks["build-tree"] = data("tree2") == as_bytes(ctx2.write)
    from old_kaldi_git_tpu_torch.tree.build_tree import cluster_leaves
    from old_kaldi_git_tpu_torch.utils.io_funcs import write_int_vector

    def map_bytes(f, mapping):
        init_kaldi_output_stream(f, True)
        write_int_vector(f, mapping)

    checks["build-tree-two-level"] = (data("tree2b") == data("tree2") and data("tree2b.map")
                                      == as_bytes(map_bytes, cluster_leaves(stats, ctx2, 40)))
    tm2 = TransitionModel.from_context_dependency(ctx2, topo)
    am1 = init_am_from_tree_stats(ctx2, stats, device="cpu")
    same_file("gmm-init-model", "1.mdl", AmGmmModel(tm2, am1).save)
    m1 = AmGmmModel.load(p("1.mdl"), device="cpu")  # mix-up reads the float32 file
    same_file("gmm-mixup", "1m.mdl", AmGmmModel(m1.tm, mixup(m1.am, CLI_TRAIN_MIXUP)).save)
    same_archive("convert-ali", p("ali_conv.ark"), "ivec",
                 ((k, convert_alignment(a, tm, tm2, ctx2)) for k, a in tali.items()))
    # the EM iterations: alignments against align_batch, the statistics
    # against accumulate_corpus on the same device, the M-step on the
    # tool's statistics
    graphs2 = read_table(o("graphs2.ark"), "fst")
    akeys, apad, anf = pad_feature_batch({k: tfeats[k] for k in tkeys if k in graphs2})
    ax = torch.from_numpy(apad).to(dev)
    like_per_frame, mdl_i = [], p("1m.mdl")
    for it, mix in enumerate(CLI_TRAIN_MIX):
        model = AmGmmModel.load(mdl_i, device=dev)
        t2p = model.tm.tid_to_pdf_array()
        csr = [fst_to_csr_native(NativeFst.from_arrays(*graphs2[k].to_arrays()), t2p)
               for k in akeys]
        alis, _ = align_batch(csr, model.am.loglikes_batch(ax), anf,
                              ViterbiOptions(beam=200.0, acoustic_scale=1.0), device=dev)
        got = read_table(o(f"ali{it}.ark"), "ivec")
        checks[f"gmm-align-compiled (iteration {it + 1})"] = sum(
            a is not None and np.array_equal(got.get(k), a) for k, a in zip(akeys, alis))
        if it == 0:
            S, A = align_shape(csr)
        rows = [k for k in tkeys if k in got and len(got[k]) == len(tfeats[k])]
        lib = AccumAmDiagGmm(model.am)
        lib.accumulate_corpus(model.am, torch.from_numpy(
            np.concatenate([tfeats[k] for k in rows])).to(dev),
            t2p[np.concatenate([got[k] for k in rows])])
        trans = np.zeros(model.tm.num_tids + 1)
        for k in rows:
            model.tm.accumulate(got[k], trans)
        with open(p(f"{it}.acc"), "rb") as f:
            accs, tstats = read_accs(f, device=dev)
        g = max(gap("gmm-acc-stats-ali / gmm-sum-accs", getattr(accs, n), getattr(lib, n))
                for n in ("occ", "mean_acc", "var_acc"))
        checks[f"gmm-acc-stats-ali + gmm-sum-accs (iteration {it + 1})"] = (
            g <= CLI_TRAIN_REL and np.array_equal(tstats, trans)
            and abs(accs.tot_like - lib.tot_like) <= CLI_TRAIN_REL * abs(lib.tot_like))
        like_per_frame.append(accs.tot_like / accs.tot_frames)
        new_am = mle_am_diag_gmm_update(model.am, accs)
        model.tm.mle_update(tstats)
        new_am = mixup(new_am, mix, occs=accs.pdf_occupancy())
        same_file(f"gmm-est (iteration {it + 1})", f"{it + 2}.mdl",
                  AmGmmModel(model.tm, new_am).save)
        mdl_i = p(f"{it + 2}.mdl")
    final = AmGmmModel.load(mdl, device=dev)
    lkeys, lpad, lnf = pad_feature_batch(tfeats)
    ll = final.am.loglikes_batch(torch.from_numpy(lpad).to(dev)).cpu().numpy()
    likes = read_table(o("likes.ark"), "mat")
    checks["gmm-compute-likes"] = sorted(likes) == lkeys and all(
        np.array_equal(likes[k], ll[i, :lnf[i]]) for i, k in enumerate(lkeys))
    del ll
    boost = AmGmmModel.load(mdl, device="cpu")
    for pdf in sorted({boost.tm.tid_to_pdf(t) for t in range(1, boost.tm.num_tids + 1)
                       if boost.tm.tid_to_phone(t) == int(sil)}):
        boost.am.pdfs[pdf].weights = boost.am.pdfs[pdf].weights * 1.2
    same_file("gmm-boost-silence", "boost.mdl", boost.save)
    # gmm-init-mono: the global mean and variance of the training features
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
    from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
    from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency

    lang = load_lang_dir(p("lang"))
    x64 = [tfeats[k].astype(np.float64) for k in tkeys]
    n = sum(len(x) for x in x64)
    s1, s2 = None, None
    for x in x64:
        s1 = x.sum(0) if s1 is None else s1 + x.sum(0)
        s2 = (x ** 2).sum(0) if s2 is None else s2 + (x ** 2).sum(0)
    mean = s1 / n
    mtopo = HmmTopology.standard(lang.real_phone_ids, silence_phones=[lang.silence_id])
    mctx = monophone_context_dependency(lang.real_phone_ids, {
        ph: mtopo.num_pdf_classes(ph) for ph in lang.real_phone_ids})
    same_file("gmm-init-mono", "mono0.mdl", AmGmmModel(
        TransitionModel.from_context_dependency(mctx, mtopo),
        AmDiagGmm.init_mono(mctx.num_pdfs, mean, np.maximum(s2 / n - mean ** 2, 1e-3),
                            device="cpu")).save)
    checks["gmm-init-mono (tree)"] = data("mono0.tree") == as_bytes(mctx.write)
    # posteriors
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs
    from old_kaldi_git_tpu_torch.hmm.posterior import post_to_pdf_post, post_to_weights

    final_tm = AmGmmModel.load(mdl, device="cpu").tm
    last = read_table(last_ali, "ivec")
    same_archive("ali-to-pdf", p("pdf.ark"), "ivec",
                 ((k, np.asarray(alignment_to_pdfs(final_tm, a), np.int32))
                  for k, a in last.items()))
    same_archive("ali-to-post", p("post.ark"), "post",
                 ((k, ali_to_post(a)) for k, a in last.items()))
    wpost = {k: weight_silence_post(ali_to_post(a), final_tm, [int(sil)], 0.0)
             for k, a in last.items()}
    same_archive("weight-silence-post", p("wpost.ark"), "post", wpost.items())
    same_archive("post-to-pdf-post", p("pdfpost.ark"), "post",
                 ((k, post_to_pdf_post(v, final_tm)) for k, v in wpost.items()))
    same_archive("post-to-weights", p("weights.ark"), "vec",
                 ((k, np.asarray(post_to_weights(v), np.float32)) for k, v in wpost.items()))
    # LDA, MLLT, fMLLR
    corpus = _Corpus(final_tm, tfeats, wpost, {k: [k] for k in tfeats})
    lda = LdaEstimate(final.am.num_pdfs, corpus.dim, dev)
    lda.accumulate(corpus.x, corpus.pdf, corpus.w)
    acc = read_arrays(p("lda.acc"), "LdaAccs")
    checks["acc-lda"] = max(gap("acc-lda", acc[k], getattr(lda, k))
                            for k in ("counts", "first", "second")) <= CLI_TRAIN_REL
    est = LdaEstimate(acc["counts"].shape[0], acc["first"].shape[1], "cpu")
    for k in ("counts", "first", "second"):
        setattr(est, k, torch.from_numpy(np.asarray(acc[k], np.float64)))
    lda_mat = est.estimate(CLI_TRAIN_LDA_DIM)

    same_file("est-lda", "lda.mat", lambda path: _write_mat(path, lda_mat))
    lda_r = _read_mat(p("lda.mat"))
    same_archive("transform-feats", p("lda.ark"), "mat",
                 ((k, (tfeats[k].astype(np.float64) @ lda_r.T).astype(np.float32))
                  for k in tkeys))
    lda_feats = read_table(o("lda.ark"), "mat")
    lda0 = AmGmmModel.load(p("lda0.mdl"), device=dev)
    lcorpus = _Corpus(lda0.tm, lda_feats, wpost, {k: [k] for k in tfeats})
    mllt = MlltAccs(lcorpus.dim, dev)
    mllt.accumulate(lda0.am, lcorpus.x, lcorpus.pdf, lcorpus.w, lcorpus.utt)
    macc = read_arrays(p("mllt.acc"), "MlltAccs")
    checks["gmm-acc-mllt"] = (gap("gmm-acc-mllt", macc["G"], mllt.G) <= CLI_TRAIN_REL
                              and abs(macc["beta"][0] - mllt.beta) <= CLI_TRAIN_REL * mllt.beta)
    est_m = MlltAccs(macc["G"].shape[1], "cpu")
    est_m.G += torch.from_numpy(np.asarray(macc["G"], np.float64))
    est_m.beta += float(macc["beta"][0])
    mllt_mat, mllt_impr = update_mllt(est_m)
    same_file("est-mllt", "mllt.mat", lambda path: _write_mat(path, mllt_mat))
    from old_kaldi_git_tpu_torch.transform.mllt import transform_gmm_means

    m_r = _read_mat(p("mllt.mat"))
    lda0_host = AmGmmModel.load(p("lda0.mdl"), device="cpu")
    transform_gmm_means(lda0_host.am, m_r)
    same_file("gmm-transform-means", "mllt.mdl", lda0_host.save)
    same_file("compose-transforms", "ldamllt.mat", lambda path: _write_mat(path, m_r @ lda_r))
    lm_r = _read_mat(p("ldamllt.mat"))
    same_archive("transform-feats (LDA+MLLT)", p("ldamllt.ark"), "mat",
                 ((k, (tfeats[k].astype(np.float64) @ lm_r.T).astype(np.float32))
                  for k in tkeys))
    lm_feats = read_table(o("ldamllt.ark"), "mat")
    mllt_model = AmGmmModel.load(p("mllt.mdl"), device=dev)
    with open(p("train_spk2utt")) as f:
        spk2utt_t = {ln.split()[0]: ln.split()[1:] for ln in f}
    scorpus = _Corpus(mllt_model.tm, lm_feats, wpost, spk2utt_t)
    trans = compute_fmllr_transforms(scorpus.fmllr_accs(mllt_model.am, dev),
                                     min_count=CLI_TRAIN_MIN_COUNT)
    same_archive("gmm-est-fmllr", p("fmllr.ark"), "mat",
                 ((s_, t.astype(np.float32)) for s_, t in zip(scorpus.speakers, trans)
                  if t is not None))
    from old_kaldi_git_tpu_torch.hmm.posterior import post_to_gpost

    gposts = {k: post_to_gpost(wpost[k], mllt_model.tm, mllt_model.am, lm_feats[k])
              for k in tkeys}
    same_archive("gmm-post-to-gpost", p("gpost.ark"), "gpost", ((k, gposts[k]) for k in tkeys))
    gread = read_table(o("gpost.ark"), "gpost")
    gaccs = []
    for s_, utts in spk2utt_t.items():
        a_ = FmllrAccs(lm_feats[utts[0]].shape[1], dev)
        for u in utts:
            a_.accumulate_gpost(mllt_model.am, lm_feats[u], gread[u])
        gaccs.append(a_)
    same_archive("gmm-est-fmllr-gpost", p("gfmllr.ark"), "mat",
                 ((s_, t.astype(np.float32)) for s_, t in zip(
                     spk2utt_t, compute_fmllr_transforms(gaccs, min_count=CLI_TRAIN_MIN_COUNT))
                  if t is not None))
    fm = read_table(o("fmllr.ark"), "mat")
    checks["fmllr speakers"] = len(fm)
    with open(p("train_utt2spk")) as f:
        utt2spk_t = dict(ln.split() for ln in f)
    same_archive("transform-feats (per speaker)", p("sat.ark"), "mat", (
        (k, (lm_feats[k].astype(np.float64) @ fm[utt2spk_t[k]][:, :-1].astype(np.float64).T
             + fm[utt2spk_t[k]][:, -1]).astype(np.float32))
        for k in tkeys if utt2spk_t[k] in fm))
    # adaptation with tri.mdl
    tri_dev = AmGmmModel.load(tri, device=dev)
    with open(p("test_spk2utt")) as f:
        spk2utt_h = {ln.split()[0]: ln.split()[1:] for ln in f}
    utt2spk_h = {u: s_ for s_, us in spk2utt_h.items() for u in us}
    bp = read_table(o("bp_ali.ark"), "ivec")
    bp_post = {k: ali_to_post(a) for k, a in bp.items()}
    checks["best paths as long as the features"] = all(len(bp[k]) == len(hfeats[k]) for k in bp)
    rt = regtree.RegressionTree.build(tri_host.am, CLI_TRAIN_REGTREE, seed=0)
    checks["gmm-make-regtree"] = data("regtree") == as_bytes(rt.write)
    hcorpus = _Corpus(tm, hfeats, bp_post, spk2utt_h)
    csr_h = read_hclg_csr(p("graph", "HCLG.fst"), tm.tid_to_pdf_array())
    ref = {k: v.split() for k, v in read_table(f"ark:{p('ref.txt')}", "text").items()}
    words_txt = {}
    for line in open(p("graph", "words.txt")):
        w_, i_ = line.split()
        words_txt[int(i_)] = w_
    wer, adapted_models = {}, []
    for kind, accs_of, estimate in (
            ("mllr", regtree.RegtreeMllrAccs,
             lambda a, t, m: [regtree.estimate_regtree_mllr(x, t, m) for x in a]),
            ("fmllr", regtree.RegtreeFmllrAccs, regtree.estimate_regtree_fmllr_speakers)):
        accs_ = []
        for si in range(len(hcorpus.speakers)):
            a_ = accs_of(tri_dev.am.dim, rt.num_baseclasses, dev)
            x_, pd_, w_, u_ = hcorpus.of(si)
            a_.accumulate(tri_dev.am, rt, x_, pd_, w_, u_)
            accs_.append(a_)
        xf = dict(zip(hcorpus.speakers, estimate(accs_, rt, CLI_TRAIN_REGTREE_MIN_COUNT)))
        same_archive(f"gmm-est-regtree-{kind}", p(f"{kind}.regx"), "regx", xf.items())
        xr = read_table(o(f"{kind}.regx"), "regx")
        if kind == "mllr":
            adapted_models.append(
                regtree.apply_mllr_to_model(tri_dev.am, rt, xr[hcorpus.speakers[0]]))
        keys_, ll_, nf_ = regtree_loglikes(tri_dev, rt, xr, utt2spk_h, hfeats, kind, dev)
        res = decode_batch(csr_h, ll_, nf_, ViterbiOptions(), device=dev)
        got = read_table(f"ark:{p(kind + '_words.txt')}", "text")
        checks[f"gmm-decode-faster-regtree-{kind}"] = got == {
            k: " ".join(str(w) for w in r.words) for k, r in zip(keys_, res) if r is not None}
        hyp = {k: [words_txt[int(w)] for w in v.split()] for k, v in got.items()}
        wer[kind] = compute_wer({k: ref[k] for k in hyp}, hyp).wer
        del ll_
    tcorpus = _Corpus(tm, tfeats, {k: weight_silence_post(ali_to_post(a), tm, [int(sil)], 0.0)
                                   for k, a in tali.items()}, spk2utt_t)
    basis = basis_fmllr.estimate_fmllr_basis(
        [a_ for a_ in tcorpus.fmllr_accs(tri_dev.am, dev) if a_.beta > 0], 40)
    same_file("gmm-basis-fmllr-training", "fmllr.basis", basis.save)
    basis = basis_fmllr.BasisFmllr.load(p("fmllr.basis"))
    bx = []
    for spk, a_ in zip(hcorpus.speakers, hcorpus.fmllr_accs(tri_dev.am, dev)):
        if a_.beta > 0:
            r_ = basis_fmllr.compute_fmllr_basis_transform(a_, basis)
            if r_ is not None:
                bx.append((spk, r_[0].astype(np.float32)))
    same_archive("gmm-est-basis-fmllr", p("basis_fmllr.ark"), "mat", bx)
    lv = lvtln.LinearVtln.init(dim, np.linspace(0.9, 1.1, 3).tolist())
    same_file("gmm-init-lvtln", "0.lvtln", lv.save)
    warped = read_table(o("tr_warped.ark"), "mat")
    lv.set_transform(0, lvtln.train_lvtln_class([(warped[k], tfeats[k]) for k in tkeys], dev))
    same_file("gmm-train-lvtln-special", "1.lvtln", lv.save)
    lv = lvtln.LinearVtln.load(p("1.lvtln"))
    lx, warps_ = [], []
    for spk, a_ in zip(hcorpus.speakers, hcorpus.fmllr_accs(tri_dev.am, dev)):
        r_ = lvtln.select_lvtln_transform(a_, lv)
        if r_ is not None:
            lx.append((spk, r_[0].astype(np.float32)))
            warps_.append((spk, f"{r_[1]:.4f}"))
    same_archive("gmm-est-lvtln-trans", p("lvtln.ark"), "mat", lx)
    checks["gmm-est-lvtln-trans (warps)"] = read_table(f"ark:{p('warps.txt')}", "text") == dict(
        warps_)
    # fMPE
    mpe = read_table(o("mpe.ark"), "post")
    checks["MPE posterior frames"] = sum(len(v) for v in mpe.values())
    f0 = fmpe.Fmpe.init(DiagGmm.load(p("ubm")), device="cpu")
    same_file("fmpe-init", "0.fmpe", f0.save)
    f0 = fmpe.Fmpe.load(p("0.fmpe"), dev)
    ds = fmpe.ModelDerivStats(tri_dev.am)
    for k in hkeys:
        if k in mpe and k in bp:
            ds.accumulate(tri_dev.am, tm, f0.transformed(hfeats[k]), mpe[k], bp[k])
    same_file("gmm-get-stats-deriv", "deriv.stats", ds.save)
    ds = fmpe.ModelDerivStats.load(p("deriv.stats"), tri_dev.am)
    fa = []
    for i, ks in enumerate(hhalves):
        acc_i = fmpe.FmpeAccs.zeros_like(f0)
        for k in ks:
            if k not in mpe:
                continue
            xt = f0.transformed(hfeats[k])
            d_ = fmpe.model_deriv_direct(tri_dev.am, tm, xt, mpe[k])
            if k in bp:
                d_ = d_ + fmpe.model_deriv_indirect(tri_dev.am, tm, xt, bp[k], ds)
            acc_i.add(f0.acc_from_deriv(hfeats[k], d_))
        got = fmpe.FmpeAccs.load(p(f"fmpe{i}.acc"), dev)
        checks[f"gmm-fmpe-acc-stats (half {i})"] = max(
            gap("gmm-fmpe-acc-stats", got.pos, acc_i.pos),
            gap("gmm-fmpe-acc-stats", got.neg, acc_i.neg)) <= CLI_TRAIN_REL
        fa.append(fmpe.FmpeAccs.load(p(f"fmpe{i}.acc"), "cpu"))
    fa[0].add(fa[1])
    same_file("fmpe-sum-accs", "fmpe.acc", fa[0].save)
    f1 = fmpe.Fmpe.load(p("0.fmpe"), "cpu")
    step = f1.update(fmpe.FmpeAccs.load(p("fmpe.acc"), "cpu"), 0.1)
    same_file("fmpe-est", "1.fmpe", f1.save)
    f1 = fmpe.Fmpe.load(p("1.fmpe"), dev)
    same_archive("fmpe-apply-transform", p("fmpe_feats.ark"), "mat",
                 ((k, f1.apply(hfeats[k]).cpu().numpy()) for k in hkeys))
    # the utilities
    same_archive("copy-matrix", p("copy_mat.ark"), "mat",
                 ((k, np.asarray(v) * 0.5) for k, v in read_table(o("lda.ark"), "mat").items()))
    same_archive("copy-vector", p("copy_vec.ark"), "vec",
                 ((k, np.asarray(v) * 2.0) for k, v in read_table(o("weights.ark"), "vec").items()))
    checks["copy-int-vector"] = data("copy_ali.ark") == data(last_ali[4:])
    same_file("sum-matrices", "sum.mat",
              lambda path: _write_mat(path, _read_mat(p("m0.mat")) + _read_mat(p("m1.mat"))))
    names = {}
    for line in open(p("lang", "phones.txt")):
        parts = line.split()
        if len(parts) == 2:
            names[int(parts[1])] = parts[0]
    want_show = []
    for ts_, (ph, hs, pdf) in enumerate(final_tm.tuples):
        want_show.append(f"Transition-state {ts_ + 1}: phone = {names.get(ph, ph)} "
                         f"hmm-state = {hs} pdf = {pdf}")
        for tid in range(final_tm.state2id[ts_], final_tm.state2id[ts_ + 1]):
            want_show.append(f" Transition-id = {tid} p = "
                             f"{float(np.exp(final_tm.log_probs[tid])):.2f}")
    checks["show-transitions"] = show.splitlines() == want_show
    aligned = read_table(f"ark:{p('align.txt')}", "text")
    mllr_words = read_table(f"ark:{p('mllr_words.txt')}", "text")
    checks["align-text"] = sorted(aligned) == sorted(mllr_words) and all(
        [a.split()[0] for a in v.split(" ; ") if a.split()[0] != "<eps>"] == ref[k]
        and [a.split()[1] for a in v.split(" ; ") if a.split()[1] != "<eps>"]
        == mllr_words[k].split() for k, v in aligned.items() if v)
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import add_self_loops, make_h_transducer

    for name, ilab in (("Ha.fst", "ilabels_h.txt"), ("Ha_nd.fst", "ilabels_nd.txt")):
        with open(p(ilab)) as f:
            info = [[int(x) for x in ln.split()] for ln in f]
        ha, _ = make_h_transducer(info, ctx2, final_tm)
        checks[f"make-h-transducer ({name})"] = data(name) == as_bytes(ha.write)
    with open(p("Ha_nd.fst"), "rb") as f:
        checks["add-self-loops"] = data("Ha_loops.fst") == as_bytes(
            add_self_loops(VectorFst.read(f), final_tm, self_loop_scale=0.1).write)
    check_seconds = time.perf_counter() - t_check
    # the kernels at the phase's shapes, against their plain versions
    k1, k3, k1_err = {}, {}, 0.0
    if on_card:
        B = len(akeys)
        k1_err = c.check_gather(torch, c.batched_table_gather, c.batched_table_gather_plain,
                                [(B, final.am.num_pdfs, A, 3, 1), (B, S, A, 1, 0)], seed=17)
        k1 = {"cli_train_align_loglikes": c.gather_at(B, final.am.num_pdfs, A, int(anf.max())),
              "cli_train_align_alpha": c.gather_at(B, S, A, 1)}
        hx = torch.from_numpy(pad_feature_batch(hfeats)[1]).to(dev)
        hx = hx.reshape(-1, hx.shape[-1]).contiguous()
        k3 = {"cli_train_em_model": c.k3_at(torch, c.gmm_loglikes, c.gmm_loglikes_plain,
                                            final.am.weights(),
                                            ax.reshape(-1, ax.shape[-1]).contiguous(), c.plug),
              "cli_train_mllr_adapted_tri": c.k3_at(torch, c.gmm_loglikes,
                                                    c.gmm_loglikes_plain,
                                                    adapted_models[0].weights(), hx, c.plug)}
        del hx
    del ax
    tools_run = {label.split(" ")[0] for label in walls}
    batch = {n for n, fn in tools.TOOLS.items() if fn.__module__.endswith("train_tools")} - {
        "compile-train-graphs", "align-equal-compiled", "gmm-align-compiled"}
    # a check is a truth, or a count that must be positive
    bad = {k: v for k, v in checks.items()
           if not (bool(v) if isinstance(v, (bool, np.bool_)) else v > 0)}
    bad.update({k: v for k, v in gaps.items() if not v <= CLI_TRAIN_REL})
    c.emit({"phase": "cli_train", "card": c.card, "train_utterances": len(tkeys),
            "test_utterances": len(hkeys), "speakers": CLI_TRAIN_SPEAKERS,
            "tools": len(tools_run & batch), "tools_wall_seconds": tools_wall,
            "check_seconds": check_seconds, "phase_seconds": time.perf_counter() - t_start,
            "tool_seconds": walls,
            "launches": {k: launches[k] for k in ("gather", "mfcc", "gmm")},
            "launches_by_tool": dev_tools, "tree_leaves": ctx2.num_pdfs,
            "em_like_per_frame": like_per_frame, "em_gaussians": final.am.num_gauss,
            "wer_percent": wer, "mllt_objf_impr": mllt_impr, "fmpe_mean_step": step,
            "checks": {k: (bool(v) if isinstance(v, (bool, np.bool_)) else int(v))
                       for k, v in checks.items()},
            "max_rel_gaps": gaps, "gather_at_cli_train_shapes": {"exact": k1_err == 0.0, **k1},
            "gmm_at_cli_train_shapes": k3})
    if bad:
        faults.append(f"cli_train: checks failed: {sorted(bad)}")
    if tools_run < batch or len(batch) != 54:
        faults.append(f"cli_train: tools not run: {sorted(batch - tools_run)}")
    if not like_per_frame[1] > like_per_frame[0]:
        faults.append(f"cli_train: like/frame did not rise: {like_per_frame}")
    if on_card and min(launches["gmm"], launches["gather"]) == 0:
        faults.append(f"cli_train: the GMM and gather kernels were not both launched: {launches}")
    return {"faults": faults, "launches": launches, "k1": k1, "k1_err": k1_err, "k3": k3}


CLI_NNET3_MINIBATCH = 32  # nnet3-train's --minibatch-size (the egs of 64 frames)
# nnet3-train's and nnet3-chain-train's learning rates.  At the tools' 1e-3,
# Adam's first sign-like steps undo more than one epoch does: the CE of
# final.am's egs rises from 0.60 to 0.89 nats a frame (4 utterances, CPU
# rehearsal), and the fresh chain model's objective in eval mode, whose
# batch-norm statistics move 1 % a step, falls from -20.3 to -22.4 over the
# epoch's 8 steps (64 utterances, CPU; -22.8 to -30.9 on the card), where
# 1e-4 raises it to -6.3
CLI_NNET3_LR = (1e-4, 1e-5)
CLI_NNET3_TOL = 1e-4  # tool vs library: loglikes (of max|ref|), printed objectives
CLI_NNET3_CHECK_UTTS = 8  # held-out utterances of the trained model's loglikes check
CLI_CHAIN_MINIBATCH = 8  # nnet3-chain-train's default
CLI_CHAIN_COMBINE_STEPS = 10  # nnet3-chain-combine's --num-steps (40 by default: 12 s)
CLI_DISC_TOL = 1e-5  # the sMBR objective, tool vs library
CLI_DISC_UTTS = 16  # of the 64 training utterances, sMBR's (cut for time: PERF.md §4)
# a chain TDNN-F at chain.mdl's widths (its trunk and prefinal layer), with
# the output of the tree that chain-build-tree makes
CLI_CHAIN_XCONFIG = """input name=input dim=39
relu-batchnorm-layer name=tdnn0 dim=512 input=Append(-1,0,1)
tdnnf-layer name=tdnnf1 dim=512 bottleneck-dim=64 time-stride=1
tdnnf-layer name=tdnnf2 dim=512 bottleneck-dim=64 time-stride=1
tdnnf-layer name=tdnnf3 dim=512 bottleneck-dim=64 time-stride=1
tdnnf-layer name=tdnnf4 dim=512 bottleneck-dim=64 time-stride=3
tdnnf-layer name=tdnnf5 dim=512 bottleneck-dim=64 time-stride=3
prefinal-layer name=prefinal dim=512
output-layer name=output dim={pdfs}
"""
CLI_NNET3_TENSOR_TOOLS = frozenset((
    "compute-mfcc-feats", "compute-cmvn-stats", "apply-cmvn", "add-deltas",
    "gmm-align-compiled", "nnet3-copy", "nnet3-am-init", "nnet3-latgen-faster", "nnet3-train",
    "nnet3-compute-prob", "nnet3-adjust-priors", "nnet3-combine", "nnet3-chain-init",
    "nnet3-chain-train", "nnet3-chain-compute-prob", "nnet3-chain-combine",
    "nnet3-discriminative-train", "nnet3-discriminative-compute-objf"))


def cli_nnet3(torch, np, c) -> dict:
    """The cli_nnet3 phase: the 21 nnet3 / chain tools of bin/nnet3_tools.py
    not run before, in-process through bin.tools.main on the cli phase's
    work directory, as Kaldi's train_dnn.py / chain/train.py run them on the
    64 training utterances: features by the feature tools (the MFCC
    kernel), tri.mdl's alignments (gmm-align-compiled: the GMM and gather
    kernels), CE egs (get, shuffle, copy to 2 archives, merge), one epoch of
    nnet3-train from the committed TDNN-F, combination, priors and the
    decode of the 64 held-out utterances; the chain graph tools, a chain
    TDNN-F at chain.mdl's widths from nnet3-chain-init, chain egs, one epoch
    of nnet3-chain-train and combination; sMBR on the committed model's
    lattices.  The kernels' counts are set to 0 just before the tools run
    and read just after; each tool is then held to the port's library on
    the same inputs (files byte for byte, models through their loglikes and
    objectives within CLI_NNET3_TOL, words equal)."""
    import contextlib
    import io

    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.bin.nnet3_tools import chain_batches, read_den_graph
    from old_kaldi_git_tpu_torch.chain.den_graph import make_denominator_graph
    from old_kaldi_git_tpu_torch.chain.loss import ChainLossOptions, chain_loss
    from old_kaldi_git_tpu_torch.chain.phone_lm import estimate_phone_lm
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs, alignment_to_phones
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet, AmNnetModel
    from old_kaldi_git_tpu_torch.models.discriminative import (
        DiscriminativeOptions, compute_discriminative_objf)
    from old_kaldi_git_tpu_torch.models.egs import (
        batch_ce_egs, batch_chain_egs, get_ce_egs, get_chain_egs, iter_merged)
    from old_kaldi_git_tpu_torch.models.train import (
        NnetTrainOptions, TrainState, combine_models, make_ce_train_step, make_optimizer)
    from old_kaldi_git_tpu_torch.recipes.chain import (
        ChainModel, ChainTrainOptions, build_chain_objects, combine_chain_models,
        make_chain_step)
    from old_kaldi_git_tpu_torch.tree.context_dep import (
        ContextDependency, monophone_context_dependency)
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.log import KaldiError
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
    from old_kaldi_git_tpu_torch.utils.wav import WaveData

    t_start = time.perf_counter()
    dev, wd = c.dev, c.workdir
    on_card = dev.type == "cuda"
    p = lambda *a: os.path.join(wd, *a)  # noqa: E731
    o = lambda n: f"ark:{p(n)}"  # noqa: E731
    tri, final_am = c.tri, os.path.abspath("exp/minilib/final.am")
    faults, walls, checks, gaps, tols = [], {}, {}, {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(label, *argv, rcs=(0,)):
        """A tool in-process (--device=cpu added to a tensor tool off the
        card): what it printed; its wall under `label`, ended by a device
        synchronise."""
        argv = list(argv)
        if not on_card and argv[0] in CLI_NNET3_TENSOR_TOOLS:
            argv.insert(1, "--device=cpu")
        out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tools.main(argv)
        sync()
        walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
        if rc not in rcs:
            raise RuntimeError(f"cli_nnet3: {label} exited {rc}")
        out.flush()
        return out.buffer.getvalue().decode()

    def data(name):
        with open(name if os.path.isabs(name) else p(name), "rb") as f:
            return f.read()

    def same_archive(name, path, holder, items):
        want = p(f"want_{name}")
        with TableWriter(f"ark:{want}", holder) as w:
            for k, v in items:
                w[k] = v
        checks[name] = data(path) == data(want)

    def gap(name, got, want, rel=True, tol=CLI_NNET3_TOL):
        """|got − want|, over max|want| when `rel`, kept under `name` with
        its tolerance.  A figure a tool prints to 4 decimals (`got` a
        float) is allowed its rounding, 5e-5, besides."""
        printed = isinstance(got, float)
        got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
        want = want.detach().cpu().numpy() if hasattr(want, "detach") else np.asarray(want)
        g = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        scale = max(float(np.abs(want).max()), 1e-300) if rel else 1.0
        gaps[name] = g / scale
        tols[name] = tol + (5e-5 / scale if printed and tol > CLI_DISC_TOL else 0.0)

    def number(out, pattern):
        return float(re.search(pattern, out)[1])

    # ---- inputs, before the counts start (host work)
    tkeys = sorted(c.twaves)[:CLI_ALIGN_UTTS]
    with TableWriter(f"ark,scp:{p('twav.ark')},{p('twav.scp')}", "wav") as w:
        for k in tkeys:
            w[k] = WaveData(samp_freq=c.minilib.SAMP_FREQ,
                            data=np.asarray(c.twaves[k], np.float32)[None])
    tri_host = AmGmmModel.load(tri, device="cpu")
    tm = tri_host.tm
    phones = ":".join(str(x) for x in tm.topo.phones)
    chain_opts = ChainTrainOptions(tree_context_width=2)

    # ---- the tools, the counts set to 0 just before them
    t_phase = time.perf_counter()
    c.zero_counts()
    c.gmm_loglikes.launches = 0
    # features (K2) and tri.mdl's alignments (K3, K1)
    run("compute-mfcc-feats", "compute-mfcc-feats", f"--samp-freq={c.minilib.SAMP_FREQ}",
        "--dither=0", f"scp:{p('twav.scp')}", o("traw.ark"))
    run("compute-cmvn-stats", "compute-cmvn-stats", o("traw.ark"), o("tcmvn.ark"))
    run("apply-cmvn", "apply-cmvn", o("tcmvn.ark"), o("traw.ark"), o("tcmn.ark"))
    run("add-deltas", "add-deltas", o("tcmn.ark"), o("tfeats.ark"))
    run("gmm-align-compiled", "gmm-align-compiled", tri, o("graphs.ark"), o("tfeats.ark"),
        o("nali.ark"))
    # CE egs
    run("ali-to-pdf", "ali-to-pdf", tri, o("nali.ark"), o("npdf.ark"))
    run("nnet3-get-egs", "nnet3-get-egs", o("tfeats.ark"), o("npdf.ark"), o("egs.ark"))
    run("nnet3-shuffle-egs", "nnet3-shuffle-egs", "--srand=1", o("egs.ark"), o("egs_shuf.ark"))
    run("nnet3-copy-egs", "nnet3-copy-egs", o("egs_shuf.ark"), o("egs_0.ark"), o("egs_1.ark"))
    run("nnet3-merge-egs", "nnet3-merge-egs", f"--minibatch-size={CLI_NNET3_MINIBATCH}",
        o("egs_0.ark"), o("egs_train.ark"))
    # CE training from the committed TDNN-F, combination, priors, the bundle
    run("nnet3-copy", "nnet3-copy", final_am, p("start.raw"))
    prob0 = number(run("nnet3-compute-prob", "nnet3-compute-prob", p("start.raw"),
                       o("egs_train.ark")), r"log-probability per frame: (\S+)")
    train_opts = (f"--minibatch-size={CLI_NNET3_MINIBATCH}", "--srand=2",
                  f"--initial-lr={CLI_NNET3_LR[0]}", f"--final-lr={CLI_NNET3_LR[1]}")
    run("nnet3-train", "nnet3-train", *train_opts, p("start.raw"), o("egs_train.ark"),
        p("trained.raw"))
    prob1 = number(run("nnet3-compute-prob", "nnet3-compute-prob", p("trained.raw"),
                       o("egs_train.ark")), r"log-probability per frame: (\S+)")
    valid = {}
    for name in ("start", "trained"):
        valid[name] = number(run("nnet3-compute-prob", "nnet3-compute-prob", p(f"{name}.raw"),
                                 o("egs_1.ark")), r"log-probability per frame: (\S+)")
    run("nnet3-combine", "nnet3-combine", p("start.raw"), p("trained.raw"), o("egs_1.ark"),
        p("combined.raw"))
    valid["combined"] = number(run("nnet3-compute-prob", "nnet3-compute-prob",
                                   p("combined.raw"), o("egs_1.ark")),
                               r"log-probability per frame: (\S+)")
    run("nnet3-adjust-priors", "nnet3-adjust-priors", p("combined.raw"), o("egs_0.ark"),
        p("final_cli.raw"))
    run("nnet3-am-init", "nnet3-am-init", tri, p("final_cli.raw"), p("final_cli.mdl"))
    wt = f"--word-symbol-table={p('graph', 'words.txt')}"
    hclg = p("graph", "HCLG.fst")
    run("nnet3-latgen-faster", "nnet3-latgen-faster", wt, p("final_cli.mdl"), hclg,
        o("feats.ark"), o("cli_nlat.ark"), f"ark,t:{p('cli_nwords.txt')}")
    # the chain graph tools: phone LM, trees, den graph
    run("ali-to-phones", "ali-to-phones", tri, o("nali.ark"), o("nphones.ark"))
    run("chain-est-phone-lm", "chain-est-phone-lm", "--ngram-order=2", o("nphones.ark"),
        p("phone_lm.fst"))
    tree_args = (tri, o("tfeats.ark"), o("nali.ark"))
    run("chain-build-tree", "chain-build-tree", "--context-width=2",
        f"--max-leaves={chain_opts.tree_max_leaves}", f"--thresh={chain_opts.tree_thresh}",
        *tree_args, p("ctree2"))
    # the biphone den graph is refused, as by the JAX tool: the phone LM's
    # file carries no state histories (ROADMAP queue 3)
    run("chain-make-den-fst", "chain-make-den-fst", p("ctree2"), p("phone_lm.fst"), p("den2"),
        rcs=(1,))
    run("chain-build-tree", "chain-build-tree", "--context-width=1", *tree_args, p("ctree1"))
    run("chain-make-den-fst", "chain-make-den-fst", p("ctree1"), p("phone_lm.fst"), p("den"))
    with open(p("ctree1"), "rb") as f:
        ctx1 = ContextDependency.read(f)
    with open(p("chain.xconfig"), "w") as f:
        f.write(CLI_CHAIN_XCONFIG.format(pdfs=ctx1.num_pdfs))
    run("nnet3-chain-init", "nnet3-chain-init", "--srand=3", p("ctree1"), p("den"),
        p("chain.xconfig"), phones, p("chain0.mdl"))
    run("nnet3-chain-get-egs", "nnet3-chain-get-egs", "--frame-subsampling-factor=3", tri,
        p("ctree1"), p("den"), o("tfeats.ark"), o("nali.ark"), o("cegs.ark"))
    run("nnet3-chain-shuffle-egs", "nnet3-chain-shuffle-egs", "--srand=4", o("cegs.ark"),
        o("cegs_shuf.ark"))
    run("nnet3-chain-copy-egs", "nnet3-chain-copy-egs", o("cegs_shuf.ark"), o("cegs_0.ark"),
        o("cegs_1.ark"))
    run("nnet3-chain-merge-egs", "nnet3-chain-merge-egs", o("cegs_shuf.ark"),
        o("cegs_train.ark"))
    cprob0 = number(run("nnet3-chain-compute-prob", "nnet3-chain-compute-prob",
                        p("chain0.mdl"), o("cegs_train.ark")), r"objective per frame: (\S+)")
    t0 = time.perf_counter()
    run("nnet3-chain-train", "nnet3-chain-train", "--srand=5", f"--initial-lr={CLI_NNET3_LR[0]}",
        f"--final-lr={CLI_NNET3_LR[1]}", p("chain0.mdl"), o("cegs_train.ark"), p("chain1.mdl"))
    chain_train_wall = time.perf_counter() - t0
    cprob1 = number(run("nnet3-chain-compute-prob", "nnet3-chain-compute-prob",
                        p("chain1.mdl"), o("cegs_train.ark")), r"objective per frame: (\S+)")
    run("nnet3-chain-combine", "nnet3-chain-combine", f"--num-steps={CLI_CHAIN_COMBINE_STEPS}",
        p("chain0.mdl"), p("chain1.mdl"), o("cegs_1.ark"), p("chain_comb.mdl"))
    cprob_comb = number(run("nnet3-chain-compute-prob", "nnet3-chain-compute-prob",
                            p("chain_comb.mdl"), o("cegs_1.ark")), r"objective per frame: (\S+)")
    # sequence training on the committed model's lattices of the first
    # CLI_DISC_UTTS utterances
    run("subset-feats", "subset-feats", f"--n={CLI_DISC_UTTS}", o("tfeats.ark"),
        o("dfeats.ark"))
    disc = ("--criterion=smbr", "--acoustic-scale=1.0")
    run("nnet3-latgen-faster", "nnet3-latgen-faster", "--acoustic-scale=1.0", p("final.mdl"),
        hclg, o("dfeats.ark"), o("denlat.ark"))
    disc_in = (o("dfeats.ark"), o("nali.ark"), o("denlat.ark"))
    dobj0 = number(run("nnet3-discriminative-compute-objf", "nnet3-discriminative-compute-objf",
                       *disc, p("final.mdl"), *disc_in), r"objf per frame: (\S+)")
    run("nnet3-discriminative-train", "nnet3-discriminative-train", *disc, p("final.mdl"),
        *disc_in, p("smbr.mdl"))
    dobj1 = number(run("nnet3-discriminative-compute-objf", "nnet3-discriminative-compute-objf",
                       *disc, p("smbr.mdl"), *disc_in), r"objf per frame: (\S+)")
    sync()
    tools_wall = time.perf_counter() - t_phase
    launches = c.read_counts("cli_nnet3")
    launches["gmm"] = c.gmm_loglikes.launches
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # ---- the library on the same inputs
    t_check = time.perf_counter()
    tfeats = read_table(o("tfeats.ark"), "mat")
    nali = read_table(o("nali.ark"), "ivec")
    pdf_ali = {k: np.asarray(alignment_to_pdfs(tm, a), np.int32) for k, a in nali.items()}
    checks["ali-to-pdf"] = read_table(o("npdf.ark"), "ivec").keys() == pdf_ali.keys() and all(
        np.array_equal(v, pdf_ali[k]) for k, v in read_table(o("npdf.ark"), "ivec").items())
    lib_egs = [(f"{k}-{i}", eg) for k in tfeats if k in pdf_ali
               for i, eg in enumerate(get_ce_egs(tfeats[k], pdf_ali[k]))]
    same_archive("nnet3-get-egs", p("egs.ark"), "egs", lib_egs)
    shuffled = read_table(o("egs.ark"), "egs")
    pairs = list(shuffled.items())
    np.random.default_rng(1).shuffle(pairs)
    same_archive("nnet3-shuffle-egs", p("egs_shuf.ark"), "egs", pairs)
    same_archive("nnet3-copy-egs (0)", p("egs_0.ark"), "egs", pairs[0::2])
    same_archive("nnet3-copy-egs (1)", p("egs_1.ark"), "egs", pairs[1::2])
    merged = sorted(pairs[0::2], key=lambda kv: kv[1].feats.shape[0])
    same_archive("nnet3-merge-egs", p("egs_train.ark"), "egs", merged)
    train_egs = [eg for _k, eg in merged]
    valid_egs = [eg for _k, eg in pairs[1::2]]

    def lib_ce(am, egs):
        """The masked CE per frame of `am` over `egs`, in runs of 128, by
        the library's batching (nnet3-compute-prob's figure)."""
        tot = n = 0.0
        with torch.no_grad():
            for group in iter_merged(egs, 128):
                bf, bl, bm = batch_ce_egs(group)
                logp = torch.log_softmax(am.logits(bf), dim=-1)
                y = torch.from_numpy(bl).to(dev).long()
                m = torch.from_numpy(bm).to(dev)
                tot += float((logp.gather(-1, y[..., None])[..., 0] * m).sum())
                n += float(m.sum())
        return tot / n

    start = AmNnet.load(final_am, device=dev)
    gap("nnet3-compute-prob (start)", prob0, lib_ce(start, train_egs), rel=False)
    # nnet3-train's flow by the library: sort, merge, shuffle the runs, step
    lib_am = AmNnet.load(final_am, device=dev)
    egs_sorted = sorted(train_egs, key=lambda e: e.feats.shape[0])
    steps = max(1, len(egs_sorted) // CLI_NNET3_MINIBATCH)
    optimizer = make_optimizer(NnetTrainOptions(initial_lr=CLI_NNET3_LR[0],
                                                final_lr=CLI_NNET3_LR[1]),
                               steps, lr_factors=lib_am.lr_factors)
    model = lib_am.model.train()
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    step_fn = make_ce_train_step(model, optimizer)
    groups = list(iter_merged(egs_sorted, CLI_NNET3_MINIBATCH))
    np.random.default_rng(2).shuffle(groups)
    step_secs = []
    for group in groups:
        batch = batch_ce_egs(group)
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, *batch)
        float(metrics["loss"])
        step_secs.append(time.perf_counter() - t0)
    model.eval()
    trained = AmNnet.load(p("trained.raw"), device=dev)
    check_keys = sorted(tfeats)[:CLI_NNET3_CHECK_UTTS]
    _, cx, _ = pad_feature_batch({k: tfeats[k] for k in check_keys})
    gap("nnet3-train (loglikes of 8 utterances)", trained.loglikes_batch(cx),
        lib_am.loglikes_batch(cx))
    gap("nnet3-compute-prob (trained)", prob1, lib_ce(trained, train_egs), rel=False)
    combined = AmNnet.load(p("combined.raw"), device=dev)
    lib_comb = combine_models([AmNnet.load(p("start.raw"), device=dev), trained],
                              {f"eg{i}": e.feats for i, e in enumerate(
                                  sorted(valid_egs, key=lambda e: e.feats.shape[0])[:128])},
                              {f"eg{i}": e.labels for i, e in enumerate(
                                  sorted(valid_egs, key=lambda e: e.feats.shape[0])[:128])})
    gap("nnet3-combine (loglikes of 8 utterances)", combined.loglikes_batch(cx),
        lib_comb.loglikes_batch(cx))
    final_cli = AmNnet.load(p("final_cli.raw"), device=dev)
    bf, _bl, bm = batch_ce_egs([eg for _k, eg in pairs[0::2]][:512])
    combined.set_priors_from_posteriors(bf, bm.sum(axis=1).astype(np.int32))
    gap("nnet3-adjust-priors", final_cli.log_priors, combined.log_priors, rel=False,
        tol=CLI_DISC_TOL)
    bundle = AmNnetModel.load(p("final_cli.mdl"), device=dev)
    csr = read_hclg_csr(hclg, tm.tid_to_pdf_array())
    hfeats = read_table(o("feats.ark"), "mat")
    hkeys, hpad, hnf = pad_feature_batch(hfeats)
    lib = decode_batch(csr, bundle.am.loglikes_batch_chunked(hpad), hnf,
                       ViterbiOptions(acoustic_scale=1.0), want_lattice=True, device=dev)
    words = read_table(f"ark:{p('cli_nwords.txt')}", "text")
    wtab = SymbolTable.read(p("graph", "words.txt"))
    same_words = sum(r is not None and words.get(k) == " ".join(wtab[w] for w in r.words)
                     for k, r in zip(hkeys, lib))
    checks["nnet3-latgen-faster (words = library decode_batch, 64 of 64)"] = (
        same_words == len(hkeys))
    ref = read_table(f"ark:{p('ref.txt')}", "text")
    wer_errors = sum(1 for k in hkeys if words.get(k) != ref[k])
    # the chain graph tools
    seqs = [alignment_to_phones(tm, nali[k]) for k in sorted(nali)]
    lm = estimate_phone_lm(seqs, 2)
    checks["chain-est-phone-lm"] = data("phone_lm.fst") == _bytes_of(lm.write)
    ph = [int(x) for x in phones.split(":")]
    checks["chain-build-tree (width 1)"] = data("ctree1") == _bytes_of(
        monophone_context_dependency(ph, {q: 1 for q in ph}).write)
    ctx2, _tm2, _den2 = build_chain_objects(tri_host, nali, c.minilib.make_lang(), chain_opts,
                                            feats=tfeats)
    checks["chain-build-tree (width 2)"] = data("ctree2") == _bytes_of(ctx2.write)
    with open(p("phone_lm.fst"), "rb") as f:
        lib_den = make_denominator_graph(VectorFst.read(f), ctx1)
    den = read_den_graph(p("den"))
    checks["chain-make-den-fst (arrays)"] = all(
        np.array_equal(getattr(den, f.name), getattr(lib_den, f.name))
        if isinstance(getattr(lib_den, f.name), np.ndarray)
        else getattr(den, f.name) == getattr(lib_den, f.name)
        for f in dataclasses.fields(lib_den))
    lib_cegs = []
    for k in tfeats:
        if k in nali:
            try:
                lib_cegs += [(f"{k}-{i}", eg) for i, eg in enumerate(get_chain_egs(
                    tfeats[k], nali[k], tm, ctx1, lib_den, 3, 5, 5))]
            except KaldiError:  # counted by the tool as it skips them
                pass
    same_archive("nnet3-chain-get-egs", p("cegs.ark"), "cegs", lib_cegs)
    cpairs = list(read_table(o("cegs.ark"), "cegs").items())
    np.random.default_rng(4).shuffle(cpairs)
    same_archive("nnet3-chain-shuffle-egs", p("cegs_shuf.ark"), "cegs", cpairs)
    same_archive("nnet3-chain-copy-egs (0)", p("cegs_0.ark"), "cegs", cpairs[0::2])
    same_archive("nnet3-chain-copy-egs (1)", p("cegs_1.ark"), "cegs", cpairs[1::2])
    cmerged = sorted(cpairs, key=lambda kv: kv[1].feats.shape[0])
    same_archive("nnet3-chain-merge-egs", p("cegs_train.ark"), "cegs", cmerged)
    cegs = [eg for _k, eg in cmerged]

    def lib_chain(cm, egs):
        """The frame-weighted chain objective per frame of `cm` over `egs`,
        in length order and groups of 8, l2 and xent off."""
        lopts = ChainLossOptions(l2_regularize=0.0, xent_regularize=0.0)
        tot = frames = 0.0
        with torch.no_grad():
            for group in iter_merged(sorted(egs, key=lambda e: e.feats.shape[0]), 8):
                bf, *sup, _x = (torch.from_numpy(np.asarray(a)).to(dev)
                                for a in batch_chain_egs(group))
                logits = cm.am.logits(bf, output_stride=cm.frame_subsampling_factor)
                _l, met = chain_loss(logits[:, : sup[1].shape[1]], cm.den, *sup, lopts)
                n = float(sup[2].sum())
                tot += float(met["objf"]) * n
                frames += n
        return tot / frames

    cm0 = ChainModel.load(p("chain0.mdl"), device=dev)
    gap("nnet3-chain-compute-prob (start)", cprob0, lib_chain(cm0, cegs))
    cm1 = ChainModel.load(p("chain1.mdl"), device=dev)
    gap("nnet3-chain-compute-prob (trained)", cprob1, lib_chain(cm1, cegs))
    # nnet3-chain-train's minibatches: its step captures the objective once
    # for each distinct set of supervision shapes; one step card vs CPU
    loss_opts = ChainLossOptions()
    csteps = max(1, len(cegs) // CLI_CHAIN_MINIBATCH)
    batches = chain_batches(cegs, CLI_CHAIN_MINIBATCH, np.random.default_rng(5))
    captures = len({tuple(np.shape(a) for a in b[1:]) for b in batches})
    step_gap = {}
    for where in ("card", "cpu"):
        wdev = dev if where == "card" else torch.device("cpu")
        wcm = ChainModel.load(p("chain0.mdl"), device=wdev)
        wmodel = copy.deepcopy(wcm.am.model).train()
        wopt = make_optimizer(NnetTrainOptions(initial_lr=CLI_NNET3_LR[0],
                                               final_lr=CLI_NNET3_LR[1]), csteps)
        _s, loss, met = make_chain_step(wmodel, wcm.den, wopt, loss_opts, 3)(
            TrainState(wopt.init(dict(wmodel.named_parameters())), 0), *batches[0])
        step_gap[where] = {"loss": float(loss), "num": float(met["num"]),
                           "den": float(met["den"])}
    frames = float(np.sum(batches[0][3]))
    scale = max(abs(step_gap["cpu"]["num"]), abs(step_gap["cpu"]["den"])) * len(
        batches[0][3]) / frames
    step_rel = abs(step_gap["card"]["loss"] - step_gap["cpu"]["loss"]) / scale
    lib_ccomb = combine_chain_models([ChainModel.load(p("chain0.mdl"), device=dev), cm1],
                                     [eg for _k, eg in cpairs[1::2]],
                                     num_steps=CLI_CHAIN_COMBINE_STEPS)
    gap("nnet3-chain-combine (objective)", cprob_comb,
        lib_chain(lib_ccomb, [eg for _k, eg in cpairs[1::2]]))
    # sequence training
    dfeats = {k: np.asarray(v, np.float32) for k, v in list(tfeats.items())[:CLI_DISC_UTTS]}
    checks["subset-feats"] = sorted(read_table(o("dfeats.ark"), "mat")) == sorted(dfeats)
    dlats = read_table(o("denlat.ark"), "lat")
    dopts = DiscriminativeOptions(criterion="smbr", acoustic_scale=1.0)
    dbundle = AmNnetModel.load(p("final.mdl"), device=dev)
    gap("nnet3-discriminative-compute-objf", dobj0,
        compute_discriminative_objf(dbundle.am, dfeats, nali, dlats, dbundle.tm, dopts),
        rel=False, tol=CLI_DISC_TOL)
    check_seconds = time.perf_counter() - t_check
    new_tools = {n for n, fn in tools.TOOLS.items() if fn.__module__.endswith("nnet3_tools")} - {
        "nnet3-init", "nnet3-copy", "nnet3-am-init", "nnet3-align-compiled",
        "nnet3-latgen-faster", "online2-wav-nnet3-latgen-faster",
        "online2-tcp-nnet3-decode-faster"}
    tools_run = {label.split(" ")[0] for label in walls}
    bad = {k: v for k, v in checks.items() if not v}
    bad.update({k: v for k, v in gaps.items() if not v <= tols[k]})
    c.emit({"phase": "cli_nnet3", "card": c.card, "train_utterances": len(tkeys),
            "test_utterances": len(hkeys), "tools": len(tools_run & new_tools),
            "tools_wall_seconds": tools_wall, "check_seconds": check_seconds,
            "phase_seconds": time.perf_counter() - t_start, "tool_seconds": walls,
            "launches": {k: launches[k] for k in ("gather", "mfcc", "gmm")},
            "peak_memory_bytes": peak,
            "egs": {"ce": len(lib_egs), "ce_train": len(train_egs), "ce_valid": len(valid_egs),
                    "chain": len(cegs)},
            "ce_log_prob_per_frame": {"start": prob0, "trained": prob1, "valid": valid},
            "ce_step_ms_median": 1e3 * float(np.median(step_secs)), "ce_steps": len(step_secs),
            "chain_tree_pdfs": {"width1": ctx1.num_pdfs, "width2": ctx2.num_pdfs},
            "chain_objf_per_frame": {"start": cprob0, "trained": cprob1,
                                     "combined_valid": cprob_comb},
            "chain_steps": len(batches), "chain_train_tool_seconds": chain_train_wall,
            "chain_train_ms_a_step": 1e3 * chain_train_wall / len(batches),
            "chain_cuda_graph_captures": captures,
            "chain_step_card_vs_cpu": dict(step_gap, relative_to_term_per_frame=step_rel),
            "smbr_objf_per_frame": {"start": dobj0, "trained": dobj1},
            "decode": {"words_equal_library": same_words, "utterances": len(hkeys),
                       "utterances_with_errors": wer_errors},
            "checks": {k: bool(v) for k, v in checks.items()}, "gaps": gaps,
            "tolerances": tols})
    if bad:
        faults.append(f"cli_nnet3: checks failed: {sorted(bad)}")
    if tools_run < new_tools or len(new_tools) != 21:
        faults.append(f"cli_nnet3: tools not run: {sorted(new_tools - tools_run)}")
    if not (prob1 > prob0 and valid["combined"] >= max(valid["start"], valid["trained"]) - 1e-3):
        faults.append(f"cli_nnet3: CE did not rise or the combination lost: {prob0} → {prob1}, "
                      f"valid {valid}")
    if not (cprob0 < cprob1 <= 0.0 and np.isfinite(cprob1)):
        faults.append(f"cli_nnet3: chain objective did not rise: {cprob0} → {cprob1}")
    if not step_rel <= NNET_STEP_TOL:
        faults.append(f"cli_nnet3: chain step card vs CPU {step_rel}")
    if not dobj1 >= dobj0 - 1e-6:
        faults.append(f"cli_nnet3: sMBR objective fell: {dobj0} → {dobj1}")
    if on_card and min(launches["gmm"], launches["gather"], launches["mfcc"]) == 0:
        faults.append(f"cli_nnet3: the kernels were not all launched: {launches}")
    return {"faults": faults, "launches": launches}


def _bytes_of(write) -> bytes:
    """What write(f) writes to a file."""
    import io

    buf = io.BytesIO()
    write(buf)
    return buf.getvalue()


NNET12_MAX_WER_PERCENT = 5.0  # ARCH_MAX_WER_PERCENT's rule: a model not converged
NNET12_YESNO_MAX_WER = 2.0  # the JAX package's own gate (tests/test_nnet12.py)
NNET12_TOL = 1e-4  # one nnet1 epoch / nnet2 iteration card vs CPU: the loss, relative
NNET12_CPU_UTTS = 64  # training utterances of that card vs CPU pass (the CPU's cost)
# the minilib cells' learning rates: those of the JAX package's yesno tests.
# At the options' defaults (nnet1 8e-3 on the mean CE; nnet2 2e-3 → 2e-4)
# neither model learns in the phase's epochs on the CPU rehearsal (PERF.md §4)
NNET1_MINILIB = dict(learn_rate=6e-2, momentum=0.5)
NNET2_MINILIB = dict(initial_lr=1e-2, final_lr=1e-3)


def nnet12(torch, np, c) -> dict:
    """The nnet12 phase: nnet1 (Nnet1Config's 2 × 256 sigmoid units at ±5
    frames, nnet-train-frmshuff with newbob, up to 20 epochs) and nnet2
    (Nnet2Config's 2 × p-norm 512 → 64 at ±4 frames on the whitening fixed
    affine, 10 iterations of parallel SGD with averaging, jobs 2 → 4, Adam)
    trained on the architectures phase's features of the 600 training
    utterances and tri_ali.pkl's labels, each decoding the 256 clean
    held-out utterances on hclg.npz at K = 1024, B = 128 (the MFCC and
    gather kernels); each family's yesno flow (recipes/nnet12.py); one nnet1
    epoch and one nnet2 iteration on the first NNET12_CPU_UTTS utterances on
    the card and on the CPU from the same weights.  Each path's counts are set to 0 just before it and read just
    after."""
    from old_kaldi_git_tpu_torch.models.nnet1 import (
        AmNnet1, Nnet1Config, Nnet1TrainOptions, train_nnet1_frmshuff)
    from old_kaldi_git_tpu_torch.models.nnet2 import (
        AmNnet2, Nnet2Config, Nnet2TrainOptions, make_fixed_affine, train_nnet2_parallel)
    from old_kaldi_git_tpu_torch.recipes import nnet12 as recipe, triphone

    dev, card, minilib, system = c.dev, c.card, c.minilib, c.system
    cpu = torch.device("cpu")
    feats, labels = c.feats, c.labels
    frames = sum(min(len(feats[k]), len(labels[k])) for k in labels if k in feats)
    faults, launches, lines = [], {}, {}
    t_phase = time.perf_counter()

    def nnet2_config():
        cfg = Nnet2Config(39, c.num_pdfs)
        spliced = np.concatenate([triphone.splice_numpy(feats[k], cfg.left_context,
                                                        cfg.right_context)
                                  for k in sorted(feats)])
        return dataclasses.replace(cfg, fixed_affine=make_fixed_affine(spliced))

    def init(family, cfg, device):
        gen = torch.Generator().manual_seed(0)
        return (AmNnet1 if family == "nnet1" else AmNnet2).init(cfg, gen, device=device)

    def train(family, am, opts, history, keys=None):
        f = feats if keys is None else {k: feats[k] for k in keys}
        if family == "nnet1":
            return train_nnet1_frmshuff(am, f, labels, opts, history=history)
        return train_nnet2_parallel(am, f, labels, opts, history=history)

    configs = {"nnet1": Nnet1Config(39, c.num_pdfs), "nnet2": nnet2_config()}
    options = {"nnet1": Nnet1TrainOptions(**NNET1_MINILIB),
               "nnet2": Nnet2TrainOptions(**NNET2_MINILIB)}
    for family in ("nnet1", "nnet2"):
        cfg, opts = configs[family], options[family]
        c.zero_counts()
        hist = []
        t0 = time.perf_counter()
        am = train(family, init(family, cfg, dev), opts, hist)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        tr_counts = c.read_counts(f"nnet12_{family}")
        c.zero_counts()
        t0 = time.perf_counter()
        wer, _ = minilib.decode_and_score(dataclasses.replace(system, am=am), beam=BEAM,
                                          max_active=MAX_ACTIVE, acoustic_scale=ACOUSTIC_SCALE,
                                          batch=BATCH)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        stats = minilib.decode_and_score.last_stats
        de_counts = c.read_counts(f"nnet12_{family}_decode")
        launches[f"nnet12_{family}"] = tr_counts
        launches[f"nnet12_{family}_decode"] = de_counts
        # a first epoch / iteration on the first NNET12_CPU_UTTS utterances,
        # on the card and on the CPU
        one, sub = {}, sorted(k for k in feats if k in labels)[:NNET12_CPU_UTTS]
        for where, device in (("card", dev), ("cpu", cpu)):
            h = []
            if family == "nnet1":
                train(family, init(family, cfg, device),
                      dataclasses.replace(opts, max_epochs=1), h, sub)
                one[where] = (h[0]["train"], h[0]["cv"], h[0]["accepted"], h[0]["halving"])
            else:
                train(family, init(family, cfg, device),
                      dataclasses.replace(opts, num_epochs=1), h, sub)
                one[where] = (h[0]["loss"],)
        rel = max(abs(a - b) / abs(b) for a, b in zip(one["card"], one["cpu"])
                  if isinstance(a, float))
        losses = [h["cv" if family == "nnet1" else "loss"] for h in hist]
        steps = sum(h["steps"] * (h.get("jobs", 1)) for h in hist)
        lines[family] = {
            "config": dataclasses.asdict(dataclasses.replace(cfg, fixed_affine=None))
            if family == "nnet2" else dataclasses.asdict(cfg),
            "options": dataclasses.asdict(opts), "frames": frames,
            "epochs" if family == "nnet1" else "iterations": len(hist),
            "losses": losses, "train_seconds": train_s,
            "step_ms": 1e3 * train_s / max(1, sum(h["steps"] for h in hist)),
            "frames_per_second": frames * len(hist) / train_s,
            "peak_memory_bytes": peak, "decode_seconds": decode_s, "wer_percent": wer,
            "errors": stats["errors"], "ref_words": stats["ref_words"],
            "launches": {"train": tr_counts, "decode": de_counts},
            "card_vs_cpu_first_pass": {"card": one["card"], "cpu": one["cpu"],
                                       "relative": rel}}
        if family == "nnet1":
            lines[family]["halvings"] = sum(h["halving"] for h in hist)
            lines[family]["accepted"] = [h["accepted"] for h in hist]
        else:
            lines[family]["jobs"] = [h["jobs"] for h in hist]
            lines[family]["replica_steps"] = steps
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            faults.append(f"nnet12 {family}: the loss did not fall: {losses}")
        if not wer <= NNET12_MAX_WER_PERCENT:
            faults.append(f"nnet12 {family}: WER {wer} > {NNET12_MAX_WER_PERCENT}")
        if not (rel <= NNET12_TOL and one["card"][2:] == one["cpu"][2:]):
            faults.append(f"nnet12 {family}: card vs CPU {one}")
        if min(de_counts["gather"], de_counts["mfcc"]) == 0:
            faults.append(f"nnet12 {family}: the decode did not go through its kernels: "
                          f"{de_counts}")
        del am
        torch.cuda.empty_cache()
    # the JAX package's yesno flows of both families
    c.zero_counts()
    t0 = time.perf_counter()
    ys = recipe.yesno_system(dev)
    yesno = {}
    for family, fn in (("nnet1", recipe.train_nnet1_yesno), ("nnet2", recipe.train_nnet2_yesno)):
        h = []
        stats = recipe.decode_wer(ys, fn(ys, history=h))
        yesno[family] = {"wer_percent": stats.wer, "errors": stats.errors,
                         "ref_words": stats.ref_len, "passes": len(h)}
        if not stats.wer <= NNET12_YESNO_MAX_WER:
            faults.append(f"nnet12 yesno {family}: {stats.report()}")
    torch.cuda.synchronize()
    launches["nnet12_yesno"] = c.read_counts("nnet12_yesno")
    c.emit({"phase": "nnet12", "card": card, **lines,
            "yesno": dict(yesno, seconds=time.perf_counter() - t0,
                          launches=launches["nnet12_yesno"]),
            "phase_seconds": time.perf_counter() - t_phase})
    return {"faults": faults, "launches": launches}


SGMM2_SUBSTATES = 4000  # total_substates of the sgmm2 phase's training: 2 a pdf, so it splits
SGMM2_CPU_UTTS = 8  # training utterances of the card-vs-CPU checks (the CPU's scoring cost)
SGMM2_STATS_TOL = 1e-9  # one iteration's statistics card vs CPU, of each array's max|ref|
SGMM2_LL_TOL = 1e-8  # loglikes card vs CPU, of max|ref|
SGMM2_AUX_TOL = 1e-6  # the EM auxiliary between realignments (tests/test_sgmm2.py:95)
SGMM2_ACOUSTIC_SCALE = 0.1
SGMM2_MAX_WER_PERCENT = 5.0  # ARCH_MAX_WER_PERCENT's rule
SGMM2_CLI_UBM = 64  # Gaussians of the SGMM2 tools' UBM
SGMM2_CLI_SPK_DIM = 13  # sgmm2-init --spk-space-dim of the tools' model
SGMM2_CLI_SUBSTATES = 2400  # sgmm2-est --split-substates of the tools' second iteration


class _SgmmAm:
    """An AmSgmm2 behind the acoustic-model seam of minilib.decode_features:
    its float64 loglikes [B, T, J] handed to the search as float32."""

    def __init__(self, torch, sgmm):
        self.torch, self.sgmm, self.device = torch, sgmm, sgmm.device

    def loglikes_batch(self, x):
        return self.sgmm.loglikes_batch(x).to(self.torch.float32)


def _rel_gap(np, got, want) -> float:
    """max|got − want| over max|want| (tensors or arrays; inf on a shape
    mismatch)."""
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = want.detach().cpu().numpy() if hasattr(want, "detach") else np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-300))


def _run_tool(torch, tools, walls, on_card, tensor_tools, label, *argv, rcs=(0,)):
    """A tool in-process (--device=cpu added to a tensor tool off the card):
    what it printed; its wall under `label`, ended by a device synchronise."""
    import contextlib
    import io

    argv = list(argv)
    if not on_card and argv[0] in tensor_tools:
        argv.insert(1, "--device=cpu")
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = tools.main(argv)
    if on_card:
        torch.cuda.synchronize()
    walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
    if rc not in rcs:
        raise RuntimeError(f"{label} exited {rc}")
    out.flush()
    return out.buffer.getvalue().decode()


def _file_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


SGMM2_TENSOR_TOOLS = frozenset((
    "sgmm2-acc-stats-ali", "sgmm2-est", "sgmm2-est-spkvecs", "sgmm2-est-fmllr",
    "sgmm2-align-compiled", "sgmm2-latgen-faster"))


def sgmm2(torch, np, c) -> dict:
    """The sgmm2 phase: SGMM2 on the minilib system, then its 9 tools.

    Training: recipes/sgmm2.train_sgmm2 from tri.mdl and the committed
    tri_ali.pkl on the 600 training utterances (features through K2) at
    Sgmm2TrainOptions() but total_substates=SGMM2_SUBSTATES: a 64-Gaussian
    UBM, D+1 = 40 phonetic dimensions, 8 EM iterations of the alternating
    flags, substates split at iteration 4, realignment at 2, 4 and 6
    through align_batch (K1 three times a scanned frame) on the align_tri
    phase's training graphs (`c.graphs`; compiled here when None).  Gates:
    the EM auxiliary does not fall between realignments; K1 three times a
    scanned frame on each realignment; one iteration's statistics and the
    loglikes of SGMM2_CPU_UTTS utterances card vs CPU.  Decode: the 256
    clean held-out utterances through minilib.decode_and_score
    (decode_batch_tokens, K1) at K=1024, B=128, acoustic scale 0.1 on
    hclg.npz; WER ≤ SGMM2_MAX_WER_PERCENT.  Tools: sgmm2-init, -info,
    -acc-stats-ali (two halves), -sum-accs, -est (vwc, then MSN with a
    split), -est-spkvecs, -acc-stats-ali with the speaker vectors,
    -est-fmllr, -align-compiled and -latgen-faster on the cli phase's work
    directory (its 64 training utterances with tri.mdl's alignments and
    training graphs, 8 round-robin speakers; its 64 held-out utterances and
    HCLG, decoded with the model trained above: the tools' own model, two
    iterations on 64 utterances, took 31-36 s to decode the 64 with its
    lattices, most of the phase), each held to the
    library on the same inputs: files byte for
    byte, alignments = align_batch's, words = decode_batch's.  The counts
    are set to 0 just before the training, the decode and the tools, and
    read just after each.  Returns {"faults", "launches"}."""
    from old_kaldi_git_tpu_torch import convert
    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.decoder.csr import fst_to_csr_native
    from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler, read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, align_batch, decode_batch
    from old_kaldi_git_tpu_torch.fst.native import NativeFst
    from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.full_gmm import FullGmm
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import (
        AmSgmm2, MleAmSgmm2Accs, Sgmm2Model, Sgmm2UpdateOptions, estimate_spk_vector,
        sgmm2_update, split_substates)
    from old_kaldi_git_tpu_torch.gmm.sgmm2_fmllr import (
        FmllrSgmm2Accs, FmllrSgmm2Options, estimate_sgmm2_fmllr_batch)
    from old_kaldi_git_tpu_torch.ivector.extractor import train_ubm
    from old_kaldi_git_tpu_torch.recipes import sgmm2 as recipe
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

    t_phase = time.perf_counter()
    dev, card, minilib = c.dev, c.card, c.minilib
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    faults, walls = [], {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- training: inputs before the counts (the model, the committed
    # alignments, the training graphs when the align phase left none)
    tri_path = os.path.abspath("exp/minilib/tri.mdl")
    tri = AmGmmModel.load(tri_path, device=dev)
    tri_ali = convert.load_pickle("exp/minilib/tri_ali.pkl")
    graphs = c.graphs
    if graphs is None:
        ctx_dep = convert.context_dependency_from_pickle(
            convert.load_pickle("exp/minilib/tree.pkl")[0])
        tkeys = sorted(c.twaves)
        graphs = dict(zip(tkeys, GraphCompiler(c.lang, ctx_dep, tri.tm).compile_csr_graphs(
            [c.ttext[k] for k in tkeys])))
    realigns = []
    real_align = recipe.align_batch

    def counted_align(*a, **kw):
        """align_batch with its K1 launches and scanned frames kept."""
        g0, tim = c.batched_table_gather.launches, {}
        out = real_align(*a, timings=tim, **kw)
        sync()
        realigns.append({"frames_scanned": int(tim["align_frames"]),
                         "gather_launches": c.batched_table_gather.launches - g0})
        return out

    topts = recipe.Sgmm2TrainOptions(total_substates=c.substates)
    hist, tim = [], {}
    c.zero_counts()
    t0 = time.perf_counter()
    tfeats = minilib.compute_feats(c.twaves, device=dev)
    sync()
    fe_s = time.perf_counter() - t0
    recipe.align_batch = counted_align
    try:
        model = recipe.train_sgmm2(tri, tfeats, tri_ali, graphs=graphs, opts=topts, device=dev,
                                   history=hist, timings=tim)
    finally:
        recipe.align_batch = real_align
    sync()
    train_s = time.perf_counter() - t0
    train_counts = c.read_counts("sgmm2")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    sg = model.sgmm
    aux_falls = [(h0["iter"], h1["iter"], h1["avg_like"] - h0["avg_like"])
                 for h0, h1 in zip(hist, hist[1:]) if h0["iter"] not in topts.realign_iters
                 and h1["avg_like"] < h0["avg_like"] - SGMM2_AUX_TOL]
    if aux_falls:
        faults.append(f"sgmm2: the EM auxiliary fell between realignments: {aux_falls}")
    if len(realigns) != len(topts.realign_iters) or any(
            r["gather_launches"] != 3 * r["frames_scanned"] for r in realigns):
        faults.append(f"sgmm2: realignments' K1 launches not three a scanned frame: {realigns}")
    if sg.num_substates != c.substates:
        faults.append(f"sgmm2: {sg.num_substates} substates after the split, not {c.substates}")
    # card vs CPU from the same inputs: one iteration's statistics under the
    # trained model, then the loglikes
    ckeys = sorted(tfeats)[:SGMM2_CPU_UTTS]
    t2p = tri.tm.tid_to_pdf_array()
    lens = [min(len(tfeats[k]), len(tri_ali[k])) for k in ckeys]
    cx = np.concatenate([np.asarray(tfeats[k], np.float64)[:n] for k, n in zip(ckeys, lens)])
    cp = np.concatenate([t2p[np.asarray(tri_ali[k])[:n]] for k, n in zip(ckeys, lens)])
    sg_cpu = sg.to(cpu)
    accs = {}
    for where, m in (("card", sg), ("cpu", sg_cpu)):
        a = MleAmSgmm2Accs(m)
        a.accumulate(m, cx, cp)
        accs[where] = a
    stats_gap = {name: _rel_gap(np, getattr(accs["card"], name), getattr(accs["cpu"], name))
                 for name in ("gamma", "y", "Y", "Q", "S")}
    stats_gap["total_like"] = abs(accs["card"].total_like - accs["cpu"].total_like) / abs(
        accs["cpu"].total_like)
    if not max(stats_gap.values()) <= SGMM2_STATS_TOL:
        faults.append(f"sgmm2: statistics card vs CPU {stats_gap}")
    # each update flag from the same statistics on both devices (a record:
    # the occupancy thresholds and the weight step's acceptance may branch)
    update_gap = {}
    for flags in ("vwc", "MS"):
        ms = {"card": sg.to(dev), "cpu": sg.to(cpu)}
        for where, m in ms.items():
            sgmm2_update(m, accs[where], Sgmm2UpdateOptions(update_flags=flags))
        update_gap[flags] = {name: _rel_gap(np, getattr(ms["card"], name),
                                            getattr(ms["cpu"], name))
                             for name in ("M", "w", "sigma_inv", "V", "C")}
    _, cpad, cnf = pad_feature_batch({k: tfeats[k] for k in ckeys})
    ll_card = sg.loglikes_batch(torch.from_numpy(cpad).to(dev), num_frames=cnf)
    ll_cpu = sg_cpu.loglikes_batch(torch.from_numpy(cpad), num_frames=cnf)
    ll_gap = _rel_gap(np, ll_card, ll_cpu)
    if not ll_gap <= SGMM2_LL_TOL:
        faults.append(f"sgmm2: loglikes card vs CPU {ll_gap} of max|ref|")
    del accs, sg_cpu, ll_card, ll_cpu, tfeats
    # ---- decode: the 256 clean held-out utterances on hclg.npz
    c.zero_counts()
    stages = {}
    t0 = time.perf_counter()
    wer, audio_s = minilib.decode_and_score(
        dataclasses.replace(c.system, am=_SgmmAm(torch, sg)), beam=BEAM,
        max_active=MAX_ACTIVE, acoustic_scale=SGMM2_ACOUSTIC_SCALE, batch=BATCH,
        timings=stages)
    sync()
    decode_s = time.perf_counter() - t0
    decode_counts = c.read_counts("sgmm2_decode")
    dstats = minilib.decode_and_score.last_stats
    if not wer <= SGMM2_MAX_WER_PERCENT:
        faults.append(f"sgmm2: WER {wer:.2f} % above {SGMM2_MAX_WER_PERCENT} %")
    if decode_counts["gather"] == 0 or decode_counts["mfcc"] == 0:
        faults.append(f"sgmm2: the decode did not go through K1 and K2: {decode_counts}")
    model.save(os.path.join(c.workdir, "sg_trained.mdl"))  # sgmm2-latgen-faster's model
    del model, sg
    if on_card:
        torch.cuda.empty_cache()

    # ---- the 9 tools on the cli phase's work directory
    wd = c.workdir
    p = lambda *a: os.path.join(wd, *a)  # noqa: E731
    o = lambda n: f"ark:{p(n)}"  # noqa: E731
    checks = {}

    def run(label, *argv, rcs=(0,)):
        return _run_tool(torch, tools, walls, on_card, SGMM2_TENSOR_TOOLS, label, *argv,
                         rcs=rcs)

    # inputs: two halves of the training features, 8 round-robin speakers,
    # the UBM (the library's, on the 64 utterances' frames)
    tfe = read_table(o("train_feats.ark"), "mat")
    tk = sorted(tfe)
    tali = read_table(o("gmm-align-compiled.ark"), "ivec")
    halves = (tk[: len(tk) // 2], tk[len(tk) // 2:])
    for i, ks in enumerate(halves):
        with TableWriter(o(f"sg_feats{i}.ark"), "mat") as w:
            for k in ks:
                w[k] = tfe[k]
    u2s = {k: f"spk{i % CLI_TRAIN_SPEAKERS}" for i, k in enumerate(tk)}
    with open(p("sg_utt2spk"), "w") as f:
        f.writelines(f"{k} {s}\n" for k, s in u2s.items())
    FullGmm.from_diag(train_ubm(np.concatenate([tfe[k] for k in tk]).astype(np.float64),
                                num_gauss=SGMM2_CLI_UBM, num_iters=4, device=dev)
                      ).save(p("sg_ubm.full"))
    hclg, words_txt = p("graph", "HCLG.fst"), p("graph", "words.txt")
    wt = f"--word-symbol-table={words_txt}"
    c.zero_counts()
    t_tools = time.perf_counter()
    run("sgmm2-init", "sgmm2-init", f"--spk-space-dim={SGMM2_CLI_SPK_DIM}", tri_path,
        p("sg_ubm.full"), p("sg0.mdl"))
    info = run("sgmm2-info", "sgmm2-info", p("sg0.mdl"))
    for i in range(2):
        run("sgmm2-acc-stats-ali", "sgmm2-acc-stats-ali", p("sg0.mdl"), o(f"sg_feats{i}.ark"),
            o("gmm-align-compiled.ark"), p(f"sg0.{i}.acc"))
    run("sgmm2-sum-accs", "sgmm2-sum-accs", p("sg0.mdl"), p("sg0.acc"), p("sg0.0.acc"),
        p("sg0.1.acc"))
    run("sgmm2-est", "sgmm2-est", "--update-flags=vwc", p("sg0.mdl"), p("sg0.acc"), p("sg1.mdl"))
    run("sgmm2-est-spkvecs", "sgmm2-est-spkvecs", f"--utt2spk={p('sg_utt2spk')}", p("sg1.mdl"),
        o("train_feats.ark"), o("gmm-align-compiled.ark"), o("sg_spkvecs.ark"))
    run("sgmm2-acc-stats-ali", "sgmm2-acc-stats-ali", f"--spk-vecs={o('sg_spkvecs.ark')}",
        f"--utt2spk={p('sg_utt2spk')}", p("sg1.mdl"), o("train_feats.ark"),
        o("gmm-align-compiled.ark"), p("sg1.acc"))
    run("sgmm2-est", "sgmm2-est", "--update-flags=MSN",
        f"--split-substates={SGMM2_CLI_SUBSTATES}", p("sg1.mdl"), p("sg1.acc"), p("sg2.mdl"))
    run("sgmm2-est-fmllr", "sgmm2-est-fmllr", f"--utt2spk={p('sg_utt2spk')}", p("sg2.mdl"),
        o("train_feats.ark"), o("gmm-align-compiled.ark"), o("sg_fmllr.ark"))
    run("sgmm2-align-compiled", "sgmm2-align-compiled", p("sg2.mdl"), o("graphs.ark"),
        o("train_feats.ark"), o("sg_ali.ark"))
    run("sgmm2-latgen-faster", "sgmm2-latgen-faster", wt, p("sg_trained.mdl"), hclg,
        o("feats.ark"), o("sg_lat.ark"), f"ark,t:{p('sg_words.txt')}")
    sync()
    tools_s = time.perf_counter() - t_tools
    tool_counts = c.read_counts("sgmm2_tools")

    # ---- the library on the same inputs
    def same(name, path, save):
        save(p(f"want_{name}"))
        checks[name] = _file_bytes(path) == _file_bytes(p(f"want_{name}"))

    base = AmGmmModel.load(tri_path, device=cpu)
    lib0 = AmSgmm2.init(FullGmm.load(p("sg_ubm.full")), base.am.num_pdfs, device=cpu)
    lib0.init_speaker_subspace(SGMM2_CLI_SPK_DIM)
    same("sgmm2-init", p("sg0.mdl"), Sgmm2Model(base.tm, lib0).save)
    checks["sgmm2-info"] = info.splitlines() == [
        f"number of pdfs {lib0.num_pdfs}", f"number of gaussians {lib0.num_gauss}",
        f"feature dimension {lib0.dim}", f"phone-space dimension {lib0.phn_dim}",
        f"number of substates {lib0.num_substates}", f"speaker-space dimension {lib0.spk_dim}",
        "symmetric false", f"number of transition-ids {base.tm.num_tids}"]

    def frames(keys, spk=None):
        xs, ps = [], []
        for k in keys:
            if (spk is None or u2s[k] == spk) and k in tali:
                n = min(len(tfe[k]), len(tali[k]))
                xs.append(np.asarray(tfe[k], np.float64)[:n])
                ps.append(t2p[np.asarray(tali[k])[:n]])
        return np.concatenate(xs), np.concatenate(ps)

    m0 = Sgmm2Model.load(p("sg0.mdl"), device=dev)
    half_accs = []
    for i, ks in enumerate(halves):
        a = MleAmSgmm2Accs(m0.sgmm)
        x, pdfs = frames(ks)
        a.accumulate(m0.sgmm, torch.from_numpy(x).to(dev), pdfs)
        same(f"sgmm2-acc-stats-ali.{i}", p(f"sg0.{i}.acc"), a.save)
        half_accs.append(a)
    half_accs[0].add(half_accs[1])
    same("sgmm2-sum-accs", p("sg0.acc"), half_accs[0].save)
    sgmm2_update(m0.sgmm, half_accs[0], Sgmm2UpdateOptions(update_flags="vwc"))
    same("sgmm2-est.vwc", p("sg1.mdl"), m0.save)
    m1 = Sgmm2Model.load(p("sg1.mdl"), device=dev)
    spks = sorted(set(u2s.values()))
    vecs = {s: estimate_spk_vector(m1.sgmm, *frames(tk, s), num_iters=2, min_count=10.0)
            for s in spks}
    want = p("want_sg_spkvecs.ark")
    with TableWriter(f"ark:{want}", "vec") as w:
        for s in spks:
            w[s] = vecs[s].cpu().numpy().astype(np.float32)
    checks["sgmm2-est-spkvecs"] = _file_bytes(p("sg_spkvecs.ark")) == _file_bytes(want)
    read_vecs = read_table(o("sg_spkvecs.ark"), "vec")
    a1 = MleAmSgmm2Accs(m1.sgmm)
    for k in tk:
        if k in tali:
            n = min(len(tfe[k]), len(tali[k]))
            a1.accumulate(m1.sgmm, torch.from_numpy(np.asarray(tfe[k], np.float64)[:n]).to(dev),
                          t2p[np.asarray(tali[k])[:n]], spk_vec=read_vecs[u2s[k]])
    same("sgmm2-acc-stats-ali.spk", p("sg1.acc"), a1.save)
    sgmm2_update(m1.sgmm, a1, Sgmm2UpdateOptions(update_flags="MSN"))
    split_substates(m1.sgmm, a1, SGMM2_CLI_SUBSTATES)
    same("sgmm2-est.MSN", p("sg2.mdl"), m1.save)
    m2 = Sgmm2Model.load(p("sg2.mdl"), device=dev)
    faccs = []
    for s in spks:
        fa = FmllrSgmm2Accs(m2.sgmm)
        fa.accumulate(m2.sgmm, *frames(tk, s))
        faccs.append(fa)
    Ws = estimate_sgmm2_fmllr_batch(m2.sgmm, faccs, FmllrSgmm2Options())
    D = m2.sgmm.dim
    ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    want = p("want_sg_fmllr.ark")
    with TableWriter(f"ark:{want}", "mat") as w:
        for s, W in zip(spks, Ws):
            w[s] = (ident if W is None else W.cpu().numpy()).astype(np.float32)
    checks["sgmm2-est-fmllr"] = _file_bytes(p("sg_fmllr.ark")) == _file_bytes(want)
    fmllr_identity = sum(W is None for W in Ws)
    # sgmm2-align-compiled against align_batch on the same graphs and loglikes
    graphs_t = read_table(o("graphs.ark"), "fst")
    m2t2p = m2.tm.tid_to_pdf_array()
    akeys, apad, anf = pad_feature_batch({k: tfe[k] for k in tk if k in graphs_t})
    acsr = [fst_to_csr_native(NativeFst.from_arrays(*graphs_t[k].to_arrays()), m2t2p)
            for k in akeys]
    all_ = m2.sgmm.loglikes_batch(torch.from_numpy(apad).to(dev))  # as batch_align scores
    alis, _ = align_batch(acsr, all_, anf, ViterbiOptions(beam=200.0, acoustic_scale=1.0),
                          device=dev)
    got = read_table(o("sg_ali.ark"), "ivec")
    align_same = sum(a is not None and k in got and np.array_equal(got[k], a)
                     for k, a in zip(akeys, alis))
    del all_
    # sgmm2-latgen-faster's words against decode_batch on the same loglikes
    hfe = read_table(o("feats.ark"), "mat")
    words = SymbolTable.read(words_txt)
    trained = Sgmm2Model.load(p("sg_trained.mdl"), device=dev)
    csr = read_hclg_csr(hclg, trained.tm.tid_to_pdf_array())
    fkeys, fpad, fnf = pad_feature_batch(hfe)
    ll = trained.sgmm.loglikes_batch(torch.from_numpy(fpad).to(dev), num_frames=fnf).to(
        torch.float32)
    lib = decode_batch(csr, ll, fnf, ViterbiOptions(), want_lattice=True, device=dev)
    tool_words = read_table(f"ark:{p('sg_words.txt')}", "text")
    words_same = sum(r is not None and tool_words.get(k) == " ".join(words[i] for i in r.words)
                     for k, r in zip(fkeys, lib))
    del ll, lib
    if on_card:
        torch.cuda.empty_cache()
    bad = sorted(k for k, v in checks.items() if not v)
    if bad:
        faults.append(f"sgmm2 tools: files other than the library's: {bad}")
    if align_same != len(tk) or words_same != len(fkeys):
        faults.append(f"sgmm2 tools: alignments {align_same}/{len(tk)}, words "
                      f"{words_same}/{len(fkeys)} equal the library's")
    if tool_counts["gather"] == 0:
        faults.append(f"sgmm2 tools did not go through K1: {tool_counts}")
    c.emit({"phase": "sgmm2", "card": card, "utterances": len(c.twaves),
            "options": dataclasses.asdict(topts), "history": hist,
            "realignments": realigns, "train_seconds": train_s,
            "front_end_seconds": fe_s, **tim,
            "peak_device_memory_bytes": peak, "substates": c.substates,
            "aux_falls_between_realignments": aux_falls,
            "stats_card_vs_cpu_of_max": stats_gap, "tolerance_stats": SGMM2_STATS_TOL,
            "update_card_vs_cpu_of_max": update_gap,
            "loglikes_card_vs_cpu_of_max": ll_gap, "tolerance_loglikes": SGMM2_LL_TOL,
            "cpu_check_utterances": len(ckeys),
            "decode": {"wer_percent": wer, "errors": dstats["errors"],
                       "ref_words": dstats["ref_words"], "audio_seconds": audio_s,
                       "wall_seconds": decode_s, "acoustic_scale": SGMM2_ACOUSTIC_SCALE,
                       "max_active": MAX_ACTIVE, "batch": BATCH, **stages,
                       "gather_launches_per_search_frame":
                           decode_counts["gather"] / max(stages.get("search_frames", 0), 1)},
            "tools": {"seconds": tools_s, "tool_seconds": walls, "files_equal": checks,
                      "align_tids_equal": align_same, "latgen_words_equal": words_same,
                      "utterances": len(tk), "decoded": len(fkeys),
                      "speakers": len(spks), "fmllr_identity_speakers": fmllr_identity},
            "launches": {"train": train_counts, "decode": decode_counts, "tools": tool_counts},
            "phase_seconds": time.perf_counter() - t_phase})
    launches = {k: train_counts[k] + decode_counts[k] + tool_counts[k]
                for k in ("gather", "mfcc")}
    return {"faults": faults, "launches": launches,
            "by_path": {"sgmm2": train_counts, "sgmm2_decode": decode_counts,
                        "sgmm2_tools": tool_counts}}


SPKID_SPEAKERS, SPKID_UTTS, SPKID_FRAMES = 64, 8, 300  # the cli_spkid corpus (seed 0)
SPKID_TRAIN_SPEAKERS = 48  # of the 64: the UBM, extractor, LDA, PLDA and LR training set
SPKID_ENROLL = 4  # of a test speaker's 8 utterances, the enrolment; the other 4 are tests
SPKID_UBM = 64  # gmm-global-init-from-feats --num-gauss (final.ie's 64 Gaussians)
SPKID_IVECTOR_DIM = 32  # ivector-extractor-init --ivector-dim (final.ie's)
SPKID_GSELECT = 20  # gmm-gselect / fgmm-gselect --n
SPKID_LDA_DIM = 24  # ivector-compute-lda --dim
SPKID_CPU_UTTS = 64  # utterances of the card-vs-CPU statistics and iVectors
SPKID_STATS_TOL = 1e-9  # the statistics card vs CPU, of each array's max|ref|
SPKID_IVEC_TOL = 1e-4  # iVectors card vs CPU, of max|ref| (train_ivector's rule)
SPKID_MAX_EER = 0.15  # tests/test_spkid_cli.py:150
SPKID_MIN_LR_ACCURACY = 0.8  # tests/test_spkid_cli.py:167
SPKID_TENSOR_TOOLS = frozenset((
    "gmm-global-init-from-feats", "gmm-gselect", "fgmm-gselect", "gmm-global-acc-stats",
    "gmm-global-get-post", "fgmm-global-acc-stats", "ivector-extractor-acc-stats",
    "ivector-extract", "compute-vad"))


def spkid_corpus(np, dim: int):
    """The generator of the JAX package's tests/test_spkid_cli.py:24-53 at
    `dim` dimensions: five cluster centres, a speaker offset in a rank-2
    basis, noise; SPKID_SPEAKERS × SPKID_UTTS utterances of SPKID_FRAMES
    frames from default_rng(0).  Returns ({utt: [T, dim] float32},
    {utt: speaker})."""
    rng = np.random.default_rng(0)
    clusters = rng.standard_normal((5, dim)) * 3.0
    basis = rng.standard_normal((2, dim))
    spk_off = rng.standard_normal((SPKID_SPEAKERS, 2)) @ basis * 0.8
    feats, utt2spk = {}, {}
    for s in range(SPKID_SPEAKERS):
        for u in range(SPKID_UTTS):
            key = f"s{s:02d}-u{u}"
            which = rng.integers(0, 5, size=SPKID_FRAMES)
            feats[key] = (clusters[which] + spk_off[s] + 0.6 * rng.standard_normal(
                (SPKID_FRAMES, dim))).astype(np.float32)
            utt2spk[key] = f"s{s:02d}"
    return feats, utt2spk


def cli_spkid(torch, np, c) -> dict:
    """The cli_spkid phase: the 30 speaker-ID tools of bin/spkid_tools.py on
    the card, in-process, as egs/sre recipes chain them: a diagonal UBM
    (init from the features, two EM iterations of gselect / acc-stats on two
    halves / sum / est), the full UBM (two iterations), an iVector extractor
    at final.ie's widths (64 Gaussians, 32 dimensions; two iterations),
    iVectors per utterance and per speaker, mean / subtraction / length
    normalisation, LDA and PLDA trained on SPKID_TRAIN_SPEAKERS speakers, the
    other speakers enrolled on SPKID_ENROLL utterances each and scored on
    the rest with every target and non-target pair, compute-eer, logistic
    regression on the training speakers' iVectors; compute-vad and
    select-voiced-frames on the cli phase's 64 held-out features.  Corpus:
    spkid_corpus at the minilib width of 39.  Each tool's file is held to
    the library's on the same inputs byte for byte; the statistics and
    iVectors of SPKID_CPU_UTTS utterances card vs CPU; EER <
    SPKID_MAX_EER and accuracy > SPKID_MIN_LR_ACCURACY.  The counts are set
    to 0 just before the tools and read just after.  Returns {"faults",
    "launches"}."""
    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.bin.spkid_tools import compute_eer, read_ie_accs, write_ie_accs
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, DiagGmm
    from old_kaldi_git_tpu_torch.gmm.full_gmm import (
        FRAME_CHUNK, AccumFullGmm, FullGmm, gselect, mle_full_gmm_update)
    from old_kaldi_git_tpu_torch.gmm.mle import (
        AccumDiagGmm, MleDiagGmmOptions, mle_diag_gmm_update)
    from old_kaldi_git_tpu_torch.ivector.extractor import (
        IvectorExtractor, acc_ivector_extractor_stats, batch_posteriors, batch_utt_stats,
        est_ivector_extractor, init_ivector_extractor, train_ubm)
    from old_kaldi_git_tpu_torch.ivector.logistic_regression import (
        LogisticRegression, LogisticRegressionConfig, train_logistic_regression)
    from old_kaldi_git_tpu_torch.ivector.plda import Plda, PldaStats, estimate_plda
    from old_kaldi_git_tpu_torch.ivector.vad import VadOptions, compute_vad_energy
    from old_kaldi_git_tpu_torch.transform.lda import LdaEstimate
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

    t_phase = time.perf_counter()
    dev, card = c.dev, c.card
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    faults, walls, checks, gaps = [], {}, {}, {}
    wd = os.path.join(c.workdir, "spkid")
    os.makedirs(wd, exist_ok=True)
    p = lambda *a: os.path.join(wd, *a)  # noqa: E731
    o = lambda n: f"ark:{p(n)}"  # noqa: E731

    def run(label, *argv, rcs=(0,)):
        return _run_tool(torch, tools, walls, on_card, SPKID_TENSOR_TOOLS, label, *argv,
                         rcs=rcs)

    # ---- inputs, before the counts: the corpus, its halves, the lists
    feats, utt2spk = spkid_corpus(np, 39)
    keys = list(feats)
    spks = sorted(set(utt2spk.values()))
    train_spks, test_spks = spks[:SPKID_TRAIN_SPEAKERS], spks[SPKID_TRAIN_SPEAKERS:]
    by_spk = {s: [k for k in keys if utt2spk[k] == s] for s in spks}
    train_keys = [k for s in train_spks for k in by_spk[s]]
    enroll = {s: by_spk[s][:SPKID_ENROLL] for s in test_spks}
    tests = [k for s in test_spks for k in by_spk[s][SPKID_ENROLL:]]
    halves = (keys[: len(keys) // 2], keys[len(keys) // 2:])
    for name, ks in (("feats.ark", keys), ("feats0.ark", halves[0]), ("feats1.ark", halves[1])):
        with TableWriter(o(name), "mat") as w:
            for k in ks:
                w[k] = feats[k]

    def write_map(name, mapping):
        with open(p(name), "w") as f:
            f.writelines(f"{k} {' '.join(v) if isinstance(v, list) else v}\n"
                         for k, v in mapping.items())

    write_map("spk2utt", by_spk)
    write_map("train_spk2utt", {s: by_spk[s] for s in train_spks})
    write_map("train_utt2spk", {k: utt2spk[k] for k in train_keys})
    write_map("enroll_spk2utt", enroll)
    with open(p("trials"), "w") as f:
        f.writelines(f"{s} {t}\n" for s in test_spks for t in tests)

    # ---- the tools, the counts set to 0 just before them
    c.zero_counts()
    t_tools = time.perf_counter()
    g = f"--n={SPKID_GSELECT}"
    run("gmm-global-init-from-feats", "gmm-global-init-from-feats",
        f"--num-gauss={SPKID_UBM}", o("feats.ark"), p("ubm0"))
    for it in range(2):
        run("gmm-gselect", "gmm-gselect", g, p(f"ubm{it}"), o("feats.ark"), o(f"gsel{it}.ark"))
        for h in range(2):
            run("gmm-global-acc-stats", "gmm-global-acc-stats", f"--gselect={o(f'gsel{it}.ark')}",
                p(f"ubm{it}"), o(f"feats{h}.ark"), p(f"diag{it}.{h}.acc"))
        run("gmm-global-sum-accs", "gmm-global-sum-accs", p(f"diag{it}.acc"),
            p(f"diag{it}.0.acc"), p(f"diag{it}.1.acc"))
        run("gmm-global-est", "gmm-global-est", "--remove-low-count-gaussians=false",
            p(f"ubm{it}"), p(f"diag{it}.acc"), p(f"ubm{it + 1}"))
    info = [run("gmm-global-info", "gmm-global-info", p("ubm2"))]
    run("gmm-global-get-post", "gmm-global-get-post", "--n=5", p("ubm2"), o("feats.ark"),
        o("post.ark"))
    run("gmm-global-to-fgmm", "gmm-global-to-fgmm", p("ubm2"), p("full0"))
    run("fgmm-global-to-gmm", "fgmm-global-to-gmm", p("full0"), p("back.diag"))
    for it in range(2):
        run("fgmm-gselect", "fgmm-gselect", g, p(f"full{it}"), o("feats.ark"),
            o(f"fgsel{it}.ark"))
        for h in range(2):
            run("fgmm-global-acc-stats", "fgmm-global-acc-stats",
                f"--gselect={o(f'fgsel{it}.ark')}", p(f"full{it}"), o(f"feats{h}.ark"),
                p(f"full{it}.{h}.acc"))
        run("fgmm-global-sum-accs", "fgmm-global-sum-accs", p(f"full{it}.acc"),
            p(f"full{it}.0.acc"), p(f"full{it}.1.acc"))
        run("fgmm-global-est", "fgmm-global-est", p(f"full{it}"), p(f"full{it}.acc"),
            p(f"full{it + 1}"))
    info.append(run("fgmm-global-info", "fgmm-global-info", p("full2")))
    run("ivector-extractor-init", "ivector-extractor-init",
        f"--ivector-dim={SPKID_IVECTOR_DIM}", p("full2"), p("ie0"))
    for it in range(2):
        for h in range(2):
            run("ivector-extractor-acc-stats", "ivector-extractor-acc-stats", p(f"ie{it}"),
                o(f"feats{h}.ark"), p(f"ie{it}.{h}.acc"))
        run("ivector-extractor-sum-accs", "ivector-extractor-sum-accs", p(f"ie{it}.acc"),
            p(f"ie{it}.0.acc"), p(f"ie{it}.1.acc"))
        run("ivector-extractor-est", "ivector-extractor-est", p(f"ie{it}"), p(f"ie{it}.acc"),
            p(f"ie{it + 1}"))
    run("ivector-extract", "ivector-extract", p("ie2"), o("feats.ark"), o("ivec.ark"))
    run("ivector-extract", "ivector-extract", f"--spk2utt={p('spk2utt')}", p("ie2"),
        o("feats.ark"), o("spk_ivec.ark"))
    run("ivector-mean", "ivector-mean", o("ivec.ark"), p("global.mean"))
    run("ivector-subtract-global-mean", "ivector-subtract-global-mean", p("global.mean"),
        o("ivec.ark"), o("ivec_c.ark"))
    run("ivector-subtract-global-mean", "ivector-subtract-global-mean", o("ivec.ark"),
        o("ivec_c2.ark"))
    run("ivector-normalize-length", "ivector-normalize-length", o("ivec_c.ark"),
        o("ivec_n.ark"))
    run("ivector-compute-lda", "ivector-compute-lda", f"--dim={SPKID_LDA_DIM}", o("ivec_n.ark"),
        p("train_utt2spk"), p("lda.mat"))
    run("ivector-transform", "ivector-transform", p("lda.mat"), o("ivec_n.ark"), o("ivec_l.ark"))
    run("ivector-normalize-length", "ivector-normalize-length", o("ivec_l.ark"),
        o("ivec_ln.ark"))
    run("ivector-compute-plda", "ivector-compute-plda", p("train_spk2utt"), o("ivec_ln.ark"),
        p("plda"))
    run("ivector-mean", "ivector-mean", p("enroll_spk2utt"), o("ivec_ln.ark"),
        o("enroll.ark"), o("num_utts.ark"))
    run("ivector-plda-scoring", "ivector-plda-scoring", f"--num-utts={o('num_utts.ark')}",
        p("plda"), o("enroll.ark"), o("ivec_ln.ark"), p("trials"), p("scores"))
    with open(p("scores")) as f, open(p("eer_in"), "w") as out:
        for ln in f:
            s, u, score = ln.split()
            out.write(f"{score} {'target' if utt2spk[u] == s else 'nontarget'}\n")
    eer_out = run("compute-eer", "compute-eer", p("eer_in"))
    run("logistic-regression-train", "logistic-regression-train", o("ivec_ln.ark"),
        p("train_utt2spk"), p("lr.mdl"))
    run("logistic-regression-eval", "logistic-regression-eval", p("lr.mdl"), o("ivec_ln.ark"),
        o("lr_post.ark"))
    cli = lambda n: f"ark:{os.path.join(c.workdir, n)}"  # noqa: E731
    run("compute-vad", "compute-vad", cli("raw.ark"), o("vad.ark"))
    run("select-voiced-frames", "select-voiced-frames", cli("feats.ark"), o("vad.ark"),
        o("voiced.ark"))
    if on_card:
        torch.cuda.synchronize()
    tools_s = time.perf_counter() - t_tools
    launches = c.read_counts("cli_spkid")

    # ---- the library on the same inputs
    def same_file(name, path, save):
        save(p(f"want_{name}"))
        checks[name] = _file_bytes(path) == _file_bytes(p(f"want_{name}"))

    def same_archive(name, path, holder, items):
        with TableWriter(o(f"want_{name}"), holder) as w:
            for k, v in items:
                w[k] = v
        checks[name] = _file_bytes(path) == _file_bytes(p(f"want_{name}"))

    def writer(obj):
        def save(path):
            with open(path, "wb") as f:
                obj.write(f)
        return save

    def load_gmm(path):
        with open(path, "rb") as f:
            iof.init_kaldi_input_stream(f)
            return (DiagGmm if iof.peek_token(f) == "<DiagGMM>" else FullGmm).read(f)

    def frames(ks):
        return torch.from_numpy(np.concatenate([feats[k] for k in ks]).astype(np.float64)).to(dev)

    def gsel_of(model, ks):
        x = frames(ks)
        return torch.cat([gselect(model, x[lo: lo + FRAME_CHUNK], SPKID_GSELECT)
                          for lo in range(0, x.shape[0], FRAME_CHUNK)]).cpu().numpy()

    x_all = np.concatenate([feats[k] for k in keys])
    same_file("gmm-global-init-from-feats", p("ubm0"),
              train_ubm(x_all[:200000], num_gauss=SPKID_UBM, num_iters=10, seed=0,
                        device=dev).save)
    starts = np.concatenate([[0], np.cumsum([len(feats[k]) for k in keys])])
    for it in range(2):
        ubm = load_gmm(p(f"ubm{it}"))
        sel = gsel_of(ubm, keys)
        same_archive(f"gmm-gselect.{it}", p(f"gsel{it}.ark"), "mat",
                     [(k, sel[starts[i]: starts[i + 1]].astype(np.float32))
                      for i, k in enumerate(keys)])
        accs = []
        for h, ks in enumerate(halves):
            a = AccumDiagGmm(ubm.num_mix, ubm.dim, dev)
            a.accumulate(ubm, frames(ks), gsel=np.concatenate(
                [sel[starts[keys.index(k)]: starts[keys.index(k) + 1]] for k in ks]))
            same_file(f"gmm-global-acc-stats.{it}.{h}", p(f"diag{it}.{h}.acc"), writer(a))
            accs.append(a)
        accs[0].add(accs[1])
        same_file(f"gmm-global-sum-accs.{it}", p(f"diag{it}.acc"), writer(accs[0]))
        with open(p(f"diag{it}.acc"), "rb") as f:
            acc_h = AccumDiagGmm.read(f, cpu)
        same_file(f"gmm-global-est.{it}", p(f"ubm{it + 1}"), mle_diag_gmm_update(
            ubm, acc_h.occ, acc_h.mean_acc, acc_h.var_acc, MleDiagGmmOptions(
                min_gaussian_occupancy=10.0, variance_floor=1e-3,
                remove_low_count_gaussians=False)).save)
    ubm2 = load_gmm(p("ubm2"))
    checks["gmm-global-info"] = info[0].splitlines() == [
        f"number of gaussians {ubm2.num_mix}", f"feature dimension {ubm2.dim}",
        "covariance type diag"]
    xk = frames(keys)
    post = torch.cat([ubm2.posteriors(xk[lo: lo + FRAME_CHUNK])
                      for lo in range(0, len(x_all), FRAME_CHUNK)]).cpu().numpy()
    del xk
    want_post = []
    for i, k in enumerate(keys):
        pk = post[starts[i]: starts[i + 1]]
        idx = np.argpartition(-pk, 4, axis=1)[:, :5]
        rows = []
        for t in range(pk.shape[0]):
            pairs = [(int(j), float(pk[t, j])) for j in idx[t] if pk[t, j] > 0.0]
            tot = sum(v for _, v in pairs) or 1.0
            rows.append([(j, v / tot) for j, v in sorted(pairs, key=lambda jv: -jv[1])])
        want_post.append((k, rows))
    same_archive("gmm-global-get-post", p("post.ark"), "post", want_post)
    del post, want_post
    same_file("gmm-global-to-fgmm", p("full0"), FullGmm.from_diag(ubm2).save)
    same_file("fgmm-global-to-gmm", p("back.diag"), load_gmm(p("full0")).to_diag().save)
    for it in range(2):
        full = load_gmm(p(f"full{it}"))
        sel = gsel_of(full, keys)
        same_archive(f"fgmm-gselect.{it}", p(f"fgsel{it}.ark"), "mat",
                     [(k, sel[starts[i]: starts[i + 1]].astype(np.float32))
                      for i, k in enumerate(keys)])
        accs = []
        for h, ks in enumerate(halves):
            a = AccumFullGmm(full.num_mix, full.dim, dev)
            a.accumulate(full, frames(ks), torch.from_numpy(np.concatenate(
                [sel[starts[keys.index(k)]: starts[keys.index(k) + 1]]
                 for k in ks]).astype(np.int64)).to(dev))
            same_file(f"fgmm-global-acc-stats.{it}.{h}", p(f"full{it}.{h}.acc"), writer(a))
            accs.append(a)
        accs[0].add(accs[1])
        same_file(f"fgmm-global-sum-accs.{it}", p(f"full{it}.acc"), writer(accs[0]))
        with open(p(f"full{it}.acc"), "rb") as f:
            acc_h = AccumFullGmm.read(f, cpu)
        same_file(f"fgmm-global-est.{it}", p(f"full{it + 1}"), mle_full_gmm_update(
            full, acc_h, min_gaussian_occupancy=10.0, variance_floor=1e-3,
            remove_low_count=False).save)
    full2 = load_gmm(p("full2"))
    checks["fgmm-global-info"] = info[1].splitlines() == [
        f"number of gaussians {full2.num_mix}", f"feature dimension {full2.dim}",
        "covariance type full"]
    same_file("ivector-extractor-init", p("ie0"),
              init_ivector_extractor(full2, SPKID_IVECTOR_DIM, 0, cpu).save)
    for it in range(2):
        ext = IvectorExtractor.load(p(f"ie{it}"), dev)
        sums = []
        for h, ks in enumerate(halves):
            A, B, aux = acc_ivector_extractor_stats(ext, [feats[k] for k in ks])
            A, B, aux = A.cpu().numpy(), B.cpu().numpy(), float(aux)
            same_file(f"ivector-extractor-acc-stats.{it}.{h}", p(f"ie{it}.{h}.acc"),
                      lambda path, A=A, B=B, aux=aux: write_ie_accs(path, A, B, aux))
            sums.append((A, B, aux))
        A, B, aux = (sums[0][0] + sums[1][0], sums[0][1] + sums[1][1], sums[0][2] + sums[1][2])
        same_file(f"ivector-extractor-sum-accs.{it}", p(f"ie{it}.acc"),
                  lambda path: write_ie_accs(path, A, B, aux))
        A, B, _ = read_ie_accs(p(f"ie{it}.acc"))
        same_file(f"ivector-extractor-est.{it}", p(f"ie{it + 1}"), est_ivector_extractor(
            IvectorExtractor.load(p(f"ie{it}"), cpu), torch.from_numpy(A),
            torch.from_numpy(B)).save)
    ext = IvectorExtractor.load(p("ie2"), dev)
    gamma, fst = batch_utt_stats(ext, [feats[k] for k in keys])
    ivec = batch_posteriors(ext, gamma, fst)[0].to(torch.float32).cpu().numpy()
    same_archive("ivector-extract", p("ivec.ark"), "vec", zip(keys, ivec))
    ix = {s: [keys.index(k) for k in by_spk[s]] for s in spks}
    spk_ivec = batch_posteriors(ext, torch.stack([gamma[ix[s]].sum(0) for s in spks]),
                                torch.stack([fst[ix[s]].sum(0) for s in spks])
                                )[0].to(torch.float32).cpu().numpy()
    same_archive("ivector-extract.spk2utt", p("spk_ivec.ark"), "vec", zip(spks, spk_ivec))
    del gamma, fst
    # the host tools: numpy on the tools' own inputs
    iv = {k: np.asarray(v) for k, v in read_table(o("ivec.ark"), "vec").items()}
    mean = np.mean(list(iv.values()), axis=0)

    def write_mean(path):
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            iof.write_vector(f, mean.astype(np.float64), dtype=np.float64)

    same_file("ivector-mean.global", p("global.mean"), write_mean)
    centred = [(k, (np.asarray(v, np.float64) - mean).astype(np.float32)) for k, v in iv.items()]
    same_archive("ivector-subtract-global-mean", p("ivec_c.ark"), "vec", centred)
    same_archive("ivector-subtract-global-mean.2", p("ivec_c2.ark"), "vec", centred)

    def normalized(items):
        out = []
        for k, v in items:
            x = np.asarray(v, np.float64)
            norm = np.linalg.norm(x)
            if norm > 0:  # the tool's order of operations
                x = x * (1.0 / (norm / np.sqrt(len(x))))
            out.append((k, x.astype(np.float32)))
        return out

    same_archive("ivector-normalize-length", p("ivec_n.ark"), "vec",
                 normalized(read_table(o("ivec_c.ark"), "vec").items()))
    ivn = {k: np.asarray(v) for k, v in read_table(o("ivec_n.ark"), "vec").items()}
    spk_id = {s: i for i, s in enumerate(train_spks)}
    lda = LdaEstimate(len(spk_id), SPKID_IVECTOR_DIM, cpu)
    lda.accumulate(np.stack([ivn[k] for k in train_keys]),
                   np.asarray([spk_id[utt2spk[k]] for k in train_keys]))
    lda_mat = lda.estimate(SPKID_LDA_DIM)

    def write_lda(path):
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            iof.write_matrix(f, lda_mat.astype(np.float64), dtype=np.float64)

    same_file("ivector-compute-lda", p("lda.mat"), write_lda)
    with open(p("lda.mat"), "rb") as f:
        iof.init_kaldi_input_stream(f)
        mat = np.asarray(iof.read_matrix(f), np.float64)
    same_archive("ivector-transform", p("ivec_l.ark"), "vec",
                 [(k, (mat @ np.asarray(v, np.float64)).astype(np.float32))
                  for k, v in ivn.items()])
    same_archive("ivector-normalize-length.lda", p("ivec_ln.ark"), "vec",
                 normalized(read_table(o("ivec_l.ark"), "vec").items()))
    ivln = {k: np.asarray(v) for k, v in read_table(o("ivec_ln.ark"), "vec").items()}
    stats = PldaStats(dim=SPKID_LDA_DIM)
    for s in train_spks:
        stats.add_samples(np.stack([ivln[k] for k in by_spk[s]]))
    same_file("ivector-compute-plda", p("plda"), estimate_plda(stats, num_em_iters=10).save)
    same_archive("ivector-mean.spk2utt", p("enroll.ark"), "vec",
                 [(s, np.mean([ivln[k] for k in enroll[s]], axis=0).astype(np.float32))
                  for s in test_spks])
    same_archive("ivector-mean.num_utts", p("num_utts.ark"), "flt",
                 [(s, float(len(enroll[s]))) for s in test_spks])
    plda = Plda.load(p("plda"))
    env = {k: np.asarray(v) for k, v in read_table(o("enroll.ark"), "vec").items()}
    e_u = plda.transform_ivectors(np.stack([env[s] for s in test_spks]), True, cpu)
    t_keys = list(ivln)
    t_u = plda.transform_ivectors(np.stack([ivln[k] for k in t_keys]), True, cpu)
    trials = [(s, t) for s in test_spks for t in tests]
    scores = plda.log_likelihood_ratios(
        e_u[[test_spks.index(s) for s, _ in trials]],
        torch.tensor([len(enroll[s]) for s, _ in trials]),
        t_u[[t_keys.index(t) for _, t in trials]]).numpy()
    checks["ivector-plda-scoring"] = _file_bytes(p("scores")) == "".join(
        f"{s} {t} {float(v):.6f}\n" for (s, t), v in zip(trials, scores)).encode()
    tgt = np.asarray([float(f"{v:.6f}") for (s, t), v in zip(trials, scores)
                      if utt2spk[t] == s])
    non = np.asarray([float(f"{v:.6f}") for (s, t), v in zip(trials, scores)
                      if utt2spk[t] != s])
    eer, _ = compute_eer(tgt, non)
    checks["compute-eer"] = eer_out.strip() == f"{100 * eer:.4f}"
    lab = {s: i for i, s in enumerate(train_spks)}
    lr_keys = [k for k in ivln if k in set(train_keys)]
    same_file("logistic-regression-train", p("lr.mdl"), train_logistic_regression(
        np.stack([ivln[k] for k in lr_keys]), [lab[utt2spk[k]] for k in lr_keys],
        LogisticRegressionConfig(), device=cpu).save)
    lr_post = LogisticRegression.load(p("lr.mdl")).log_posteriors(
        np.stack([ivln[k] for k in t_keys]), cpu).numpy()
    same_archive("logistic-regression-eval", p("lr_post.ark"), "vec",
                 [(k, v.astype(np.float32)) for k, v in zip(t_keys, lr_post)])
    accuracy = float(np.mean([int(np.argmax(lr_post[t_keys.index(k)])) == lab[utt2spk[k]]
                              for k in lr_keys]))
    raw = read_table(cli("raw.ark"), "mat")
    vad = {k: compute_vad_energy(torch.from_numpy(np.ascontiguousarray(
        f[None, :, 0], np.float32)).to(dev), VadOptions())[0].cpu().numpy()
        for k, f in raw.items()}
    same_archive("compute-vad", p("vad.ark"), "vec", vad.items())
    hfe = read_table(cli("feats.ark"), "mat")
    voiced = []
    for k, f in hfe.items():
        mask = np.asarray(vad[k]) > 0.5
        x = np.asarray(f)[: len(mask)][mask[: len(f)]]
        if len(x):
            voiced.append((k, x))
    same_archive("select-voiced-frames", p("voiced.ark"), "mat", voiced)
    voiced_share = sum(len(x) for _, x in voiced) / max(sum(len(f) for f in hfe.values()), 1)
    # card vs CPU from the same inputs: the statistics and iVectors of the
    # first SPKID_CPU_UTTS utterances
    sub = keys[:SPKID_CPU_UTTS]
    xs = np.concatenate([feats[k] for k in sub]).astype(np.float64)
    out = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        da = AccumDiagGmm(ubm2.num_mix, ubm2.dim, d)
        da.accumulate(ubm2, torch.from_numpy(xs).to(d))
        fa = AccumFullGmm(full2.num_mix, full2.dim, d)
        fa.accumulate(full2, torch.from_numpy(xs).to(d))
        e = IvectorExtractor.load(p("ie2"), d)
        A, B, _ = acc_ivector_extractor_stats(e, [feats[k] for k in sub])
        gm, fs = batch_utt_stats(e, [feats[k] for k in sub])
        out[where] = {"diag_occ": da.occ, "diag_mean": da.mean_acc, "diag_var": da.var_acc,
                      "full_occ": fa.occ, "full_mean": fa.mean_acc, "full_cov": fa.cov_acc,
                      "ie_A": A, "ie_B": B, "ivectors": batch_posteriors(e, gm, fs)[0]}
    for name in out["card"]:
        gaps[name] = _rel_gap(np, out["card"][name], out["cpu"][name])
    del out
    if on_card:
        torch.cuda.empty_cache()
    bad = sorted(k for k, v in checks.items() if not v)
    if bad:
        faults.append(f"cli_spkid: files other than the library's: {bad}")
    stats_gap = max(v for k, v in gaps.items() if k != "ivectors")
    if not (stats_gap <= SPKID_STATS_TOL and gaps["ivectors"] <= SPKID_IVEC_TOL):
        faults.append(f"cli_spkid: card vs CPU {gaps}")
    if not eer < SPKID_MAX_EER:
        faults.append(f"cli_spkid: EER {eer} not under {SPKID_MAX_EER}")
    if not accuracy > SPKID_MIN_LR_ACCURACY:
        faults.append(f"cli_spkid: logistic-regression accuracy {accuracy}")
    ran = set(walls)
    c.emit({"phase": "cli_spkid", "card": card, "utterances": len(keys),
            "frames": int(len(x_all)), "speakers": len(spks),
            "train_speakers": len(train_spks), "trials": len(trials),
            "target_trials": int(len(tgt)), "eer": eer, "eer_gate": SPKID_MAX_EER,
            "lr_accuracy": accuracy, "lr_gate": SPKID_MIN_LR_ACCURACY,
            "ubm_gaussians": [load_gmm(p(f"ubm{i}")).num_mix for i in range(3)],
            "voiced_share": voiced_share, "tools_run": len(ran),
            "tools_seconds": tools_s, "tool_seconds": walls, "files_equal": checks,
            "card_vs_cpu_of_max": gaps, "tolerance_stats": SPKID_STATS_TOL,
            "tolerance_ivectors": SPKID_IVEC_TOL, "cpu_check_utterances": len(sub),
            "launches": launches, "phase_seconds": time.perf_counter() - t_phase})
    return {"faults": faults, "launches": launches}


KWS_WORDS, KWS_PHRASES, KWS_ABSENT = 100, 20, 10  # the cli_kws keyword list
KWS_FRAME_SHIFT = 0.01  # seconds a frame (kws-search --frame-shift, compute-atwv's times)
KWS_ACOUSTIC_SCALE = 0.1  # lattice-to-kws-index's and kws-search's default
KWS_THRESHOLD = 0.5  # compute-atwv --threshold: the hits a system would report


def best_path_word_frames(lat, lm_scale: float, ac_scale: float):
    """The words of a lattice's best path with their frames: [(word, first
    frame, end frame)], a word running from the arc that carries it to the
    next word's (the decode's lattices put a word on its first arc)."""
    from old_kaldi_git_tpu_torch.lat.lattice import _topo_order

    inf = float("inf")
    dist = [inf] * lat.num_states
    back = [None] * lat.num_states
    dist[lat.start] = 0.0
    for s in _topo_order(lat):
        if dist[s] == inf:
            continue
        for a in lat.arcs[s]:
            d = dist[s] + lat.combined(a, lm_scale, ac_scale)
            if d < dist[a.nextstate]:
                dist[a.nextstate], back[a.nextstate] = d, (s, a)
    ends = [(dist[s] + lm_scale * g + ac_scale * ac, s)
            for s, (g, ac) in enumerate(lat.finals) if lat.is_final(s) and dist[s] < inf]
    if not ends:
        return []
    s, path = min(ends)[1], []
    while back[s] is not None:
        s, a = back[s][0], back[s][1]
        path.append(a)
    out, frame = [], 0
    for a in reversed(path):
        if a.olabel:
            if out:
                out[-1][2] = frame
            out.append([a.olabel, frame, None])
        if a.ilabel:
            frame += 1
    if out:
        out[-1][2] = frame
    return [tuple(w) for w in out]


def cli_kws(torch, np, c) -> dict:
    """The cli_kws phase: the 4 keyword-search tools on the lattice_outputs
    phase's 64 noisy lattices (`c.lattices`; decoded here as that phase
    decodes them when None), written as a "lat" archive.
    lattice-to-kws-index of the archive and of each half, kws-index-union of
    the halves, kws-search with --index on KWS_WORDS single words and
    KWS_PHRASES two-word phrases from the 64 references and KWS_ABSENT
    vocabulary words that no lattice holds, compute-atwv against the
    occurrences on each lattice's best path (hits at KWS_THRESHOLD and
    above).  The index files and results
    are held byte for byte to library build_kws_index / merge_indexes /
    search_index / search_phrase on the archive's lattices; absent keywords
    get no hit; the ATWV is a record, as is the index of the in-memory
    lattices (their float64 costs against the archive's float32).  Host
    code: no kernel is launched.  Returns {"faults", "launches"}."""
    from old_kaldi_git_tpu_torch.bin import tools
    from old_kaldi_git_tpu_torch.kws.atwv import compute_atwv
    from old_kaldi_git_tpu_torch.kws.search import (
        build_kws_index, merge_indexes, save_index, search_index, search_phrase)
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

    t_phase = time.perf_counter()
    dev, card, minilib = c.dev, c.card, c.minilib
    on_card = dev.type == "cuda"
    faults, walls, checks = [], {}, {}
    wd = tempfile.mkdtemp(prefix="okt_kws_")
    p = lambda *a: os.path.join(wd, *a)  # noqa: E731
    o = lambda n: f"ark:{p(n)}"  # noqa: E731
    words = c.system.words
    word_id = {w: i for i, w in enumerate(words)}
    opts = minilib.MinilibOptions()
    waves, text = minilib.make_test_set(opts, noise=minilib.NOISE_EVAL)
    keys = sorted(waves)[:LATTICE_UTTS]
    lats = c.lattices
    if lats is None:
        from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
        from old_kaldi_git_tpu_torch.recipes import decode

        gmm = AmGmmModel.load("exp/minilib/tri.mdl", device=dev)
        feats = minilib.compute_feats({k: waves[k] for k in keys}, device=dev)
        lats = decode.decode_dataset_with_lattices(gmm, c.system.csr, words, feats,
                                                   decode.DecodeOptions(), LATTICE_BEAM)
        del gmm, feats
    try:
        # ---- inputs: the archive and its halves, the keywords, the references
        lkeys = sorted(lats)
        halves = (lkeys[: len(lkeys) // 2], lkeys[len(lkeys) // 2:])
        for name, ks in (("lats.ark", lkeys), ("lats0.ark", halves[0]),
                         ("lats1.ark", halves[1])):
            with TableWriter(o(name), "lat") as w:
                for k in ks:
                    w[k] = lats[k]
        refs = [[word_id[w] for w in text[k]] for k in keys]
        uniq = sorted({w for r in refs for w in r})
        singles = [uniq[i] for i in np.linspace(0, len(uniq) - 1, min(KWS_WORDS, len(uniq))
                                                ).astype(int)]
        pairs = sorted({(r[i], r[i + 1]) for r in refs for i in range(len(r) - 1)})
        phrases = [pairs[i] for i in np.linspace(0, len(pairs) - 1, min(KWS_PHRASES, len(pairs))
                                                 ).astype(int)]
        seen = {a.olabel for lat in lats.values() for arcs in lat.arcs for a in arcs}
        unseen = [i for i, w in enumerate(words)
                  if i and i not in seen and w[0] not in "<#!"]
        absent = [unseen[i] for i in np.linspace(0, len(unseen) - 1,
                                                 min(KWS_ABSENT, len(unseen))).astype(int)]
        kws = {**{f"KW-{w:05d}": [w] for w in singles},
               **{f"KWP-{a:05d}-{b:05d}": [a, b] for a, b in phrases},
               **{f"KWX-{w:05d}": [w] for w in absent}}
        with open(p("keywords.txt"), "w") as f:
            f.writelines(f"{k} {' '.join(map(str, ws))}\n" for k, ws in kws.items())
        ref_lines, total_frames = [], 0
        for k in lkeys:
            best = best_path_word_frames(lats[k], 1.0, KWS_ACOUSTIC_SCALE)
            total_frames += max([e for _, _, e in best] + [0])
            seq = [w for w, _, _ in best]
            for kw, ws in kws.items():
                n = len(ws)
                for i in range(len(seq) - n + 1):
                    if seq[i: i + n] == ws:
                        ref_lines.append(f"{kw} {k} {best[i][1] * KWS_FRAME_SHIFT:.2f} "
                                         f"{best[i + n - 1][2] * KWS_FRAME_SHIFT:.2f}\n")
        with open(p("ref.txt"), "w") as f:
            f.writelines(ref_lines)
        duration = f"{total_frames * KWS_FRAME_SHIFT:.2f}"

        # ---- the tools, the counts set to 0 just before them
        c.zero_counts()
        t_tools = time.perf_counter()

        def run(label, *argv):
            return _run_tool(torch, tools, walls, on_card, (), label, *argv)

        run("lattice-to-kws-index", "lattice-to-kws-index", o("lats.ark"), p("all.idx"))
        for h in range(2):
            run("lattice-to-kws-index", "lattice-to-kws-index", o(f"lats{h}.ark"),
                p(f"half{h}.idx"))
        run("kws-index-union", "kws-index-union", p("half0.idx"), p("half1.idx"),
            p("union.idx"))
        run("kws-search", "kws-search", f"--index={p('union.idx')}",
            f"--frame-shift={KWS_FRAME_SHIFT}", o("lats.ark"), p("keywords.txt"),
            p("results.txt"))
        atwv_out = run("compute-atwv", "compute-atwv", f"--threshold={KWS_THRESHOLD}",
                       duration, p("ref.txt"), p("results.txt"))
        tools_s = time.perf_counter() - t_tools
        launches = c.read_counts("cli_kws")

        # ---- the library on the archive's lattices
        alats = read_table(o("lats.ark"), "lat")
        min_lp = float(np.log(1e-4))

        def index_of(ks, source):
            return build_kws_index({k: source[k] for k in ks}, lm_scale=1.0,
                                   ac_scale=KWS_ACOUSTIC_SCALE, min_log_post=min_lp)

        for name, idx in (("all.idx", index_of(lkeys, alats)),
                          ("half0.idx", index_of(halves[0], alats)),
                          ("half1.idx", index_of(halves[1], alats))):
            save_index(idx, p("want_" + name))
            checks[f"lattice-to-kws-index.{name}"] = (
                _file_bytes(p(name)) == _file_bytes(p("want_" + name)))
        merged = merge_indexes([index_of(halves[0], alats), index_of(halves[1], alats)])
        save_index(merged, p("want_union.idx"))
        checks["kws-index-union"] = _file_bytes(p("union.idx")) == _file_bytes(
            p("want_union.idx"))
        lines, hits = [], {}
        for kw, ws in sorted(kws.items()):
            if len(ws) == 1:
                found = [(h.utt, h.tbeg, h.tend, h.log_post) for h in search_index(merged, ws[0])
                         if h.log_post >= min_lp]
            else:
                found = [(u, b, e, lp) for u, lat in sorted(alats.items())
                         for b, e, lp in search_phrase(lat, ws, lm_scale=1.0,
                                                       ac_scale=KWS_ACOUSTIC_SCALE,
                                                       min_log_post=min_lp)]
            hits[kw] = len(found)
            lines += [f"{kw} {u} {b * KWS_FRAME_SHIFT:.2f} {e * KWS_FRAME_SHIFT:.2f} "
                      f"{np.exp(lp):.6f}\n" for u, b, e, lp in found]
        checks["kws-search"] = _file_bytes(p("results.txt")) == "".join(lines).encode()
        absent_hits = sum(hits[k] for k in kws if k.startswith("KWX-"))
        ref_entries = [(a, b, float(t0), float(t1)) for a, b, t0, t1 in
                       (ln.split() for ln in ref_lines)]
        hyp_entries = [(a, b, float(t0), float(t1), float(s)) for a, b, t0, t1, s in
                       (ln.split() for ln in lines) if float(s) >= KWS_THRESHOLD]
        atwv, _ = compute_atwv(float(duration), ref_entries, hyp_entries)
        checks["compute-atwv"] = atwv_out.strip() == f"ATWV = {atwv:.4f}"
        # the in-memory lattices' index against the archive's (a record)
        mem = index_of(lkeys, lats)
        arc_idx = index_of(lkeys, alats)
        mem_hits = sum(len(v) for v in mem.values())
        arc_hits = sum(len(v) for v in arc_idx.values())
        same_hits = all(len(mem.get(w, [])) == len(arc_idx.get(w, [])) and all(
            (a.utt, a.tbeg, a.tend) == (b.utt, b.tbeg, b.tend)
            for a, b in zip(mem.get(w, []), arc_idx.get(w, []))) for w in set(mem) | set(arc_idx))
        lp_gap = max([abs(a.log_post - b.log_post) for w in set(mem) & set(arc_idx)
                      for a, b in zip(mem[w], arc_idx[w])] + [0.0])
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    bad = sorted(k for k, v in checks.items() if not v)
    if bad:
        faults.append(f"cli_kws: files other than the library's: {bad}")
    if absent_hits:
        faults.append(f"cli_kws: {absent_hits} hits for keywords no lattice holds")
    if any(launches[k] for k in ("gather", "mfcc")):
        faults.append(f"cli_kws: host tools launched a kernel: {launches}")
    c.emit({"phase": "cli_kws", "card": card, "lattices": len(lkeys),
            "keywords": {"words": len(singles), "phrases": len(phrases), "absent": len(absent)},
            "hits": sum(hits.values()), "hits_by_kind": {
                kind: sum(v for k, v in hits.items() if k.startswith(pre))
                for kind, pre in (("words", "KW-"), ("phrases", "KWP-"), ("absent", "KWX-"))},
            "reference_occurrences": len(ref_lines), "trials_seconds": float(duration),
            "atwv": atwv, "atwv_threshold": KWS_THRESHOLD, "index_words": len(arc_idx), "index_occurrences": arc_hits,
            "in_memory_index": {"occurrences": mem_hits, "same_occurrences": same_hits,
                                "max_abs_log_post_gap": lp_gap},
            "files_equal": checks, "tools_seconds": tools_s, "tool_seconds": walls,
            "launches": launches, "phase_seconds": time.perf_counter() - t_phase})
    return {"faults": faults, "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--noisy", action="store_true",
                    help="also decode the set re-synthesised at noise 400")
    ap.add_argument("--profile-frames", type=int, default=0,
                    help="frames of one chunk's search under torch.profiler")
    ap.add_argument("--only", choices=["architectures", "nnet12", "cli", "cli_lattice",
                                       "cli_train", "cli_nnet3", "sgmm2", "cli_spkid",
                                       "cli_kws"],
                    help="build the kernels, load the system and run only these "
                         "phases (no final line: a partial run); cli_lattice, "
                         "cli_train, cli_nnet3, sgmm2 and cli_spkid run the cli phase "
                         "first, whose work directory they read (sgmm2 compiles its "
                         "training graphs itself); cli_kws decodes its lattices as "
                         "lattice_outputs does; nnet12 runs architectures first, whose "
                         "features it trains on")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    os.chdir(os.path.dirname(os.path.abspath(__file__)))

    import numpy as np

    from old_kaldi_git_tpu_torch import convert
    from old_kaldi_git_tpu_torch.decoder.csr import build_tile_graph
    from old_kaldi_git_tpu_torch.decoder.viterbi import (
        ViterbiOptions, _token_budget, align_batch, align_shape, decode_batch,
        decode_batch_tokens)
    from old_kaldi_git_tpu_torch.device import card_name_and_power_limit
    from old_kaldi_git_tpu_torch.feat import MfccOptions, extract_frames
    from old_kaldi_git_tpu_torch.feat.window import num_frames
    from old_kaldi_git_tpu_torch.fst import native
    from old_kaldi_git_tpu_torch.lat import native as lat_native
    from old_kaldi_git_tpu_torch.ivector.extractor import OnlineIvectorExtractor
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.online.streaming import (
        OnlineFeaturePipeline, StreamingDecoder, StreamingTokenDecoder)
    from old_kaldi_git_tpu_torch.lat.lattice import (
        lattice_best_path, lattice_from_decode, lattice_from_token_records)
    from old_kaldi_git_tpu_torch.ops import _build
    from old_kaldi_git_tpu_torch.ops.gather_kernel import (
        batched_table_gather, batched_table_gather_plain)
    from old_kaldi_git_tpu_torch.ops.gmm_kernel import gmm_loglikes, gmm_loglikes_plain
    from old_kaldi_git_tpu_torch.ops.mfcc_kernel import (
        fused_mfcc_from_frames, fused_mfcc_reference, make_mfcc_weights, mel_spans,
        mfcc_route)
    from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
    from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
    from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
    from old_kaldi_git_tpu_torch.recipes import decode, minilib, toy, yesno
    from old_kaldi_git_tpu_torch.gmm.mle import (
        AccumAmDiagGmm, mixup, mle_am_diag_gmm_update)
    from old_kaldi_git_tpu_torch.recipes.gmm_common import GmmTrainOptions
    from old_kaldi_git_tpu_torch.tree.build_tree import accumulate_tree_stats, leaf_digests
    from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer, edit_distance

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_name_and_power_limit()

    def zero_counts():
        batched_table_gather.launches = 0
        fused_mfcc_from_frames.launches = 0
        fused_mfcc_from_frames.launches_by_route = {"fft": 0, "dft": 0}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def read_counts(name):
        """K1's and K2's launches since zero_counts(), K2's by route; every
        path's front end must take the fft route"""
        got = {"gather": batched_table_gather.launches,
               "mfcc": fused_mfcc_from_frames.launches,
               "mfcc_by_route": dict(fused_mfcc_from_frames.launches_by_route)}
        if got["mfcc_by_route"]["fft"] != got["mfcc"]:
            raise RuntimeError(f"{name}: the front end left the fft route: {got}")
        return got

    # ---- phase 1: device, build: the CUDA kernels and, beside them in
    # threads, the native graph library the training graphs need and the
    # native lattice determinization
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        graph_lib = pool.submit(native.build)
        lattice_lib = pool.submit(lat_native.build)
        _build.build()
        graph_lib.result()
        lattice_lib.result()
    logs = _build.build_logs()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernel_build_seconds": round(_build.build_seconds, 2),
          "graph_library_build_seconds": round(native.build_seconds, 2),
          "lattice_library_build_seconds": round(lat_native.build_seconds, 2),
          "ptxas": {"gather": ptxas_by_entry(logs.get("gather", "")),
                    "mfcc": ptxas_by_entry(logs.get("mfcc", "")),
                    "gmm": ptxas_by_depth(logs.get("gmm", ""))}})

    # the cli phase's graph, built through the CLI in a spawned process from
    # here on (host work); the phase waits for it at the end of the run
    cli_dir = tempfile.mkdtemp(prefix="okt_cli_")
    cli_pool = cli_graph_future = None
    if args.only not in ("architectures", "nnet12", "cli_kws"):
        cli_pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        cli_graph_future = cli_pool.submit(cli_graph, cli_dir)
    # host work of later phases in another spawned process, from here on: the
    # rescore phase's 4-gram (about 40 s), then train_chain's graph
    host_pool = rescore_lm_future = None
    if not args.only:
        host_pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        rescore_lm_future = host_pool.submit(minilib.rescore_lm, minilib.MinilibOptions(),
                                             RESCORE["full_lm_order"])

    # ---- the system (needed for the main path's kernel shapes) --------------
    t0 = time.perf_counter()
    system = minilib.load_system("exp/minilib", device=dev)
    load_s = time.perf_counter() - t0
    tg = build_tile_graph(system.csr)
    K = max(4, min(MAX_ACTIVE, system.csr.num_states))
    E = _token_budget(system.csr, K, tg.md) * tg.md
    P = system.am.config.num_outputs
    t0 = time.perf_counter()
    chain = minilib.load_chain_system("exp/minilib", device=dev)
    chain_load_s = time.perf_counter() - t0
    ctg = build_tile_graph(chain.csr)
    Kc = max(4, min(CHAIN_MAX_ACTIVE, chain.csr.num_states))
    Ec = _token_budget(chain.csr, Kc, ctg.md) * ctg.md
    Pc = chain.model.am.config.num_outputs
    # the rescore path decodes the flagship graph at K = 1024: E as above
    Kr = max(4, min(RESCORE_MAX_ACTIVE, system.csr.num_states))
    Er = _token_budget(system.csr, Kr, tg.md) * tg.md
    # the iVector systems, and the streaming decoders (their [1, W/fsf, P]
    # acoustic windows give K1 its B = 1 tables)
    t0 = time.perf_counter()
    ivec_am, ivec_ext = minilib.ivector_models(system)
    chain_iv = minilib.load_chain_system("exp/minilib", device=dev, use_ivectors=True)
    ivec_load_s = time.perf_counter() - t0
    Ki = max(4, min(IVEC_MAX_ACTIVE, system.csr.num_states))
    Ei = _token_budget(system.csr, Ki, tg.md) * tg.md
    sil = [minilib.silence_phone_id(minilib.make_lexicon(minilib.MinilibOptions()))]
    tid_to_phone = convert.tid_to_phone_from_transition_model(
        convert.load_pickle("exp/minilib/tree.pkl")[1])
    svopts = ViterbiOptions(beam=BEAM, max_active=STREAM_MAX_ACTIVE, acoustic_scale=1.0)
    fsf = chain.model.frame_subsampling_factor

    def run_architectures(topts, twaves, with_nnet12=True):
        """Phases architectures, architectures_parity, stream_lstm and, with
        `with_nnet12`, nnet12 on the architectures' training features; a
        fault ends the run.  Returns their K1 and K2 counts by path."""
        arch = architectures(torch, np, argparse.Namespace(
            dev=dev, card=card, emit=emit, minilib=minilib, system=system, topts=topts,
            twaves=twaves, zero_counts=zero_counts, read_counts=read_counts, sil=sil,
            tid_to_phone=tid_to_phone))
        if not with_nnet12:
            return arch["launches"]
        res = nnet12(torch, np, argparse.Namespace(
            dev=dev, card=card, emit=emit, minilib=minilib, system=system, feats=arch["feats"],
            labels=arch["labels"], num_pdfs=arch["num_pdfs"], zero_counts=zero_counts,
            read_counts=read_counts))
        if res["faults"]:
            raise RuntimeError("nnet12: " + "; ".join(res["faults"]))
        return {**arch["launches"], **res["launches"]}

    def run_cli(twaves, ttext, lattice=True, train=True, nnet3=True, sgmm=True, spkid=True,
                graphs=None, lang=None):
        """The cli phase and, with `lattice`, cli_lattice, with `train`,
        cli_train, with `nnet3`, cli_nnet3, with `sgmm`, sgmm2 (on the
        training graphs `graphs`, compiled with `lang` when None), with
        `spkid`, cli_spkid after it on its work directory, which is removed
        at the end; their faults end the run.  Returns the six phases'
        results (None for a phase not run)."""
        nonlocal plug
        plug = torch.randn((8192, 8192), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(15))
        lat = trn = nn3 = sg = sp = None
        try:
            res = cli(torch, np, argparse.Namespace(
                dev=dev, card=card, emit=emit, minilib=minilib, system=system, twaves=twaves,
                ttext=ttext, sil=sil, workdir=cli_dir, graph_future=cli_graph_future,
                graph_pool=cli_pool, zero_counts=zero_counts, read_counts=read_counts,
                gmm_loglikes=gmm_loglikes, gmm_loglikes_plain=gmm_loglikes_plain,
                check_gather=check_gather, batched_table_gather=batched_table_gather,
                batched_table_gather_plain=batched_table_gather_plain,
                gather_at=lambda *a: gather_at(*a), k3_at=k3_at, plug=plug))
            if res["faults"]:
                raise RuntimeError("cli: " + "; ".join(res["faults"]))
            if lattice:
                lat = cli_lattice(torch, np, argparse.Namespace(
                    dev=dev, card=card, emit=emit, workdir=cli_dir,
                    tri=os.path.abspath("exp/minilib/tri.mdl"),
                    keys=sorted(system.test_waves)[:CLI_UTTS], sil=sil, ttext=ttext,
                    end_words=res["end_words"], zero_counts=zero_counts,
                    read_counts=read_counts, gmm_loglikes=gmm_loglikes,
                    gmm_loglikes_plain=gmm_loglikes_plain, k3_at=k3_at, plug=plug))
                if lat["faults"]:
                    raise RuntimeError("cli_lattice: " + "; ".join(lat["faults"]))
            if train:
                trn = cli_train(torch, np, argparse.Namespace(
                    dev=dev, card=card, emit=emit, workdir=cli_dir,
                    tri=os.path.abspath("exp/minilib/tri.mdl"), sil=sil,
                    zero_counts=zero_counts, read_counts=read_counts, gmm_loglikes=gmm_loglikes,
                    gmm_loglikes_plain=gmm_loglikes_plain, check_gather=check_gather,
                    batched_table_gather=batched_table_gather,
                    batched_table_gather_plain=batched_table_gather_plain,
                    gather_at=lambda *a: gather_at(*a), k3_at=k3_at, plug=plug))
                if trn["faults"]:
                    raise RuntimeError("cli_train: " + "; ".join(trn["faults"]))
            if nnet3:
                nn3 = cli_nnet3(torch, np, argparse.Namespace(
                    dev=dev, card=card, emit=emit, workdir=cli_dir, minilib=minilib,
                    twaves=twaves, tri=os.path.abspath("exp/minilib/tri.mdl"),
                    zero_counts=zero_counts, read_counts=read_counts,
                    gmm_loglikes=gmm_loglikes))
                if nn3["faults"]:
                    raise RuntimeError("cli_nnet3: " + "; ".join(nn3["faults"]))
            plug = None
            torch.cuda.empty_cache()
            if sgmm:
                sg = sgmm2(torch, np, argparse.Namespace(
                    dev=dev, card=card, emit=emit, minilib=minilib, system=system,
                    twaves=twaves, ttext=ttext, graphs=graphs,
                    lang=lang if lang is not None or graphs is not None else
                    minilib.make_lang(minilib.MinilibOptions()),
                    substates=SGMM2_SUBSTATES, workdir=cli_dir, zero_counts=zero_counts,
                    read_counts=read_counts, batched_table_gather=batched_table_gather))
                if sg["faults"]:
                    raise RuntimeError("sgmm2: " + "; ".join(sg["faults"]))
            if spkid:
                sp = cli_spkid(torch, np, argparse.Namespace(
                    dev=dev, card=card, emit=emit, workdir=cli_dir, zero_counts=zero_counts,
                    read_counts=read_counts))
                if sp["faults"]:
                    raise RuntimeError("cli_spkid: " + "; ".join(sp["faults"]))
        finally:
            plug = None
            torch.cuda.empty_cache()
            shutil.rmtree(cli_dir, ignore_errors=True)
        return res, lat, trn, nn3, sg, sp

    if args.only in ("architectures", "nnet12"):
        topts = minilib.MinilibOptions()
        run_architectures(topts, minilib.training_set(topts)[0],
                          with_nnet12=args.only == "nnet12")
        emit({"phase": "total", "card": card, "partial": args.only,
              "seconds": round(time.perf_counter() - t_start, 1)})
        return 0

    def stream_decoder(graph, am, t2p, chunk, step=1):
        scores = am.loglikes_batch if step == 1 else (
            lambda x: am.logits(x, output_stride=step))
        return StreamingTokenDecoder(
            graph, scores, sil, t2p, svopts, am_left_context=am.config.left_context,
            am_right_context=am.config.right_context, chunk_quantum=chunk,
            frame_subsampling_factor=step, device=dev)

    sdec = stream_decoder(system.csr, system.am, tid_to_phone, STREAM_CHUNK)
    cdec = stream_decoder(chain.csr, chain.model.am, chain.model.tid_to_phone,
                          STREAM_CHAIN_CHUNK, fsf)
    if (sdec.E * tg.md, cdec.E * ctg.md) != (Ei, Ec):
        raise RuntimeError("the streaming decoders' budgets are not the batch paths'")
    ws, wc = sdec.window_frames, cdec.window_frames // fsf  # window rows

    # ---- phase 2: each kernel against its plain version ----------------------
    # K1 at the main path's shape, contiguous and as a frame of a [B, T, P]
    # tensor (row-strided, as the decoder passes it), at ragged shapes (an
    # E that is not a multiple of 4 with aligned rows: the bulk copy with
    # scalar indices and stores), with rows that are not 16-byte aligned
    # (P = 129 at t > 0, staged by the threads), and with a table row beyond
    # a block's shared memory (the kernel then reads device memory): every
    # instance of csrc/gather.cu; and at the chain path's shape (a frame of
    # the [64, 256, 1624] logits, read in place) and the rescore path's
    # (a frame of [16, T, 2000] loglikes); at the CE+iVec shape (K = 2048,
    # B = 64), and with B = 1 as the streaming decoders pass a row of their
    # acoustic window's output, in place, at both widths
    k1_err = check_gather(torch, batched_table_gather, batched_table_gather_plain,
                          [(BATCH, P, E, 1, 0), (BATCH, P, E, 3, 1), (BATCH, P, E - 1, 1, 0),
                           (3, 50, 7, 1, 0),
                           (9, 129, 1031, 1, 0), (9, 129, 1032, 4, 1),
                           (5, 129, 4100, 4, 3), (2, 70000, 333, 1, 0),
                           (2, 70000, 336, 2, 1),
                           (CHAIN_BATCH, Pc, Ec, 256, 7), (CHAIN_BATCH, Pc, Ec, 1, 0),
                           (RESCORE_BATCH, P, Er, 3, 1), (RESCORE_BATCH, P, Er, 1, 0),
                           (IVEC_BATCH, P, Ei, 3, 1), (1, P, Ei, ws, 7), (1, P, Ei, 1, 0),
                           (1, Pc, Ec, wc, 11), (1, Pc, Ec, 1, 0)])
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames3 = torch.randn((BATCH, 3, P), device="cuda", generator=gen)
    table = frames3[:, 1].contiguous()
    idx = torch.randint(0, P, (BATCH, E), device="cuda", generator=gen,
                        dtype=torch.int32)
    idx64 = idx.long()
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    k1_ms = time_ms(torch, lambda: batched_table_gather(table, idx), plug=plug)
    k1_strided_ms = time_ms(torch, lambda: batched_table_gather(frames3[:, 1], idx),
                            plug=plug)
    # the copy the decoder no longer makes before each frame's gather
    k1_copy_ms = time_ms(torch, lambda: frames3[:, 1].contiguous(), plug=plug)
    k1_plain_ms = time_ms(torch, lambda: batched_table_gather_plain(table, idx),
                          plug=plug)
    k1_lib_ms = time_ms(torch, lambda: torch.gather(table, 1, idx64), plug=plug)
    k1_host_ms = time_ms(torch, lambda: batched_table_gather(table, idx))
    # yardstick: the smallest kernel, a fill of one float, timed the same way
    one = torch.empty(1, device="cuda")
    k1_fill_ms = time_ms(torch, lambda: one.fill_(0.0), plug=plug)
    k1_bytes = 4 * BATCH * (2 * E + P)
    k1_bound_ms = 1e3 * k1_bytes / H100_HBM_BYTES_PER_S
    del frames3

    def gather_at(b, p, e, t_len):
        """K1 at a path's shape, its table a frame of a [b, t_len, p] tensor:
        kernel, plain version and torch.gather, timed as above, and the
        bound (its bytes at the card's memory rate)."""
        frames = torch.randn((b, t_len, p), device="cuda", generator=gen)
        tab = frames[:, t_len // 2]
        ix = torch.randint(0, p, (b, e), device="cuda", generator=gen, dtype=torch.int32)
        ix64 = ix.long()
        nbytes = 4 * b * (2 * e + p)
        out = {"shape": [b, p, e], "table": f"frame {t_len // 2} of [{b},{t_len},{p}]",
               "kernel_ms": time_ms(torch, lambda: batched_table_gather(tab, ix), plug=plug),
               "plain_ms": time_ms(torch, lambda: batched_table_gather_plain(tab, ix),
                                   plug=plug),
               "library_ms": time_ms(torch, lambda: torch.gather(tab, 1, ix64), plug=plug),
               "bytes": nbytes, "bound_ms": 1e3 * nbytes / H100_HBM_BYTES_PER_S,
               "bound_by": "bytes"}
        del frames
        return out

    k1_chain = gather_at(CHAIN_BATCH, Pc, Ec, 256)
    k1_rescore = gather_at(RESCORE_BATCH, P, Er, 768)
    k1_ivec = gather_at(IVEC_BATCH, P, Ei, 768)
    k1_stream = gather_at(1, P, Ei, ws)
    k1_stream_chain = gather_at(1, Pc, Ec, wc)

    # K2 at the frame count of the first 128-utterance front-end chunk
    # (W = 256), on that chunk's real frames, on the same waves framed as
    # 16 kHz audio (W = 512), in 15 ms and 127 ms windows (W = 128 and
    # W = 1024: the 16x4 and the three-pass 16x8x4 plans) with ragged N, on
    # random frames at W = 512 and at W = 400 (round_to_power_of_two=False:
    # the "dft" route) with ragged N, and at N = 45
    opts8 = MfccOptions()
    opts8.frame_opts.samp_freq = minilib.SAMP_FREQ
    opts8.frame_opts.dither = 0.0
    keys = sorted(system.test_waves)[:minilib.FEAT_CHUNK]
    mlen = max(system.test_waves[k].shape[0] for k in keys)
    batch = np.zeros((len(keys), mlen), np.float32)
    for i, k in enumerate(keys):
        batch[i, : system.test_waves[k].shape[0]] = system.test_waves[k]
    batch = torch.from_numpy(batch).to(dev)

    def frames_of(opts):
        fr, _ = extract_frames(batch, opts.frame_opts)
        return fr.reshape(-1, fr.shape[-1]).contiguous()

    frames8 = frames_of(opts8)
    if frames8.shape[0] != len(keys) * num_frames(mlen, opts8.frame_opts):
        raise RuntimeError("front-end chunk has an unexpected frame count")
    opts16 = MfccOptions()
    opts16.frame_opts.dither = 0.0
    opts400 = MfccOptions()
    opts400.frame_opts.dither = 0.0
    opts400.frame_opts.round_to_power_of_two = False
    opts128 = MfccOptions()
    opts128.frame_opts.samp_freq = minilib.SAMP_FREQ
    opts128.frame_opts.dither = 0.0
    opts128.frame_opts.frame_length_ms = 15.0  # 120 samples, padded to 128
    opts1024 = MfccOptions()
    opts1024.frame_opts.samp_freq = minilib.SAMP_FREQ
    opts1024.frame_opts.dither = 0.0
    opts1024.frame_opts.frame_length_ms = 127.0  # 1,016 samples, padded to 1,024
    frames16 = frames_of(opts16)
    frames128 = frames_of(opts128)[:-3]
    frames1024 = frames_of(opts1024)[:-3]
    rand16 = 1000.0 * torch.randn((1237, 512), device="cuda", generator=gen)
    # white noise, as at W = 512, and the real waves framed as 16 kHz audio,
    # which leave the upper half of the band nearly empty, so that the fp32
    # plain version loses its small bins.  All of those frames are held
    # against both plain versions; their first 2,999 (the noise case's
    # shape) against the float64 one only, and the fp32 plain version's own
    # distance from it is reported
    frames400 = 1000.0 * torch.randn((2999, 400), device="cuda", generator=gen)
    real400 = frames_of(opts400)[:-3]
    all_opts = (opts8, opts16, opts400, opts128, opts1024)
    w8, w16, w400, w128, w1024 = (make_mfcc_weights(o, device=dev) for o in all_opts)
    w8d, w16d, w400d, w128d, w1024d = (
        make_mfcc_weights(o, device=dev, dtype=torch.float64) for o in all_opts)
    if ((frames16.shape[1], w400[0].shape[0], frames128.shape[1], frames1024.shape[1])
            != (512, 400, 128, 1024)):
        raise RuntimeError("the checked windows are not 512, 400, 128 and 1024 samples")
    by_route = dict(fused_mfcc_from_frames.launches_by_route)
    k2_err, k2_err64, k2_plain_own = check_mfcc(
        torch, fused_mfcc_from_frames, fused_mfcc_reference,
        [(frames8, w8, w8d, True), (frames16, w16, w16d, True), (rand16, w16, w16d, True),
         (frames128, w128, w128d, True), (frames1024, w1024, w1024d, True),
         (frames400, w400, w400d, True), (real400, w400, w400d, True),
         (real400[:2999], w400, w400d, False),
         (frames8[:45], w8, w8d, True)])
    k2_check_routes = {r: fused_mfcc_from_frames.launches_by_route[r] - by_route[r]
                       for r in by_route}
    if k2_check_routes != {"fft": 6, "dft": 3}:
        raise RuntimeError(f"K2's checks took the routes {k2_check_routes}")
    # K2 on VTLN-warped mel tables (Mfcc(..., vtln_warp=w)), the first
    # front-end chunk's frames, against both plain versions on the same
    # warped tables; their spans must fit the kernel's span table
    k2_vtln = {}
    for warp in VTLN_WARPS:
        ww = make_mfcc_weights(opts8, device=dev, vtln_warp=warp)
        ww64 = make_mfcc_weights(opts8, device=dev, dtype=torch.float64, vtln_warp=warp)
        err, err64, _ = check_mfcc(torch, fused_mfcc_from_frames, fused_mfcc_reference,
                                   [(frames8, ww, ww64, True)])
        k2_vtln[str(warp)] = {
            "max_abs_err": err, "max_abs_err_vs_float64_plain": err64,
            "span_bins": int(mel_spans(ww[2].cpu().numpy())[:, 1].sum()),
            "span_table_bins": 2 * ww[2].shape[0] + ww[2].shape[1],
            "mel_table_differs_from_unwarped": not torch.equal(ww[2], w8[2]),
            "kernel_ms": time_ms(torch, lambda: fused_mfcc_from_frames(frames8, ww), reps=10,
                                 plug=plug)}
    mfcc_smem = _build.bind("mfcc", "okt_fused_mfcc_smem", [ctypes.c_int] * 4,
                            restype=ctypes.c_longlong)
    k2_smem = {str(wd): mfcc_smem(mfcc_route(wd) == "fft", wd, w8[2].shape[1], w8[3].shape[1])
               for wd in (128, 256, 512, 1024, 400, 2048)}
    refusals = check_refusals(torch, batched_table_gather,
                              fused_mfcc_from_frames, w16)
    n, w = frames8.shape
    nb, c = w8[2].shape[1], w8[3].shape[1]
    k2_ms = time_ms(torch, lambda: fused_mfcc_from_frames(frames8, w8), reps=10,
                    plug=plug)
    k2_plain_ms = time_ms(torch, lambda: fused_mfcc_reference(frames8, w8), reps=10,
                          plug=plug)
    k2_rfft_ms = time_ms(torch, lambda: torch.fft.rfft(frames8, dim=1), reps=10,
                         plug=plug)
    k2_512_ms = time_ms(torch, lambda: fused_mfcc_from_frames(frames16, w16), reps=10,
                        plug=plug)
    k2_400_ms = time_ms(torch, lambda: fused_mfcc_from_frames(frames400, w400),
                        reps=10, plug=plug)
    del plug
    spans8 = int(mel_spans(w8[2].cpu().numpy())[:, 1].sum())
    k2_flops = mfcc_flops(n, w, spans8, nb, c)
    k2_bytes = 4 * (n * w + n * c)
    k2_ops_ms = 1e3 * k2_flops / H100_FP64_FLOPS
    k2_bytes_ms = 1e3 * k2_bytes / H100_HBM_BYTES_PER_S
    k2_bound_ms = max(k2_ops_ms, k2_bytes_ms)
    # the former bound: the dense DFT product in three TF32 products
    k2_dense_flops = 2 * n * w * (w // 2) * 2 + 2 * n * (w // 2) * nb + 2 * n * nb * c
    k2_dense_ms = 1e3 * TF32_SPLIT_PRODUCTS * k2_dense_flops / H100_TF32_FLOPS
    n16 = frames16.shape[0]
    k2_512_bound_ms = max(
        1e3 * 4 * n16 * (512 + c) / H100_HBM_BYTES_PER_S,
        1e3 * mfcc_flops(n16, 512, int(mel_spans(w16[2].cpu().numpy())[:, 1].sum()),
                         nb, c) / H100_FP64_FLOPS)
    del frames16, frames400, rand16, batch, frames128, frames1024, real400
    emit({"phase": "kernels", "card": card,
          "gather": {"shape": [BATCH, P, E], "exact": k1_err == 0.0, "kernel_ms": k1_ms,
                     "kernel_ms_row_strided_table": k1_strided_ms,
                     "removed_column_copy_ms": k1_copy_ms,
                     "plain_ms": k1_plain_ms, "library_ms": k1_lib_ms,
                     "bound_ms": k1_bound_ms, "bytes": k1_bytes,
                     "ms_per_call_host_bound": k1_host_ms,
                     "one_float_fill_ms": k1_fill_ms,
                     "chain_shape": k1_chain, "rescore_shape": k1_rescore,
                     "ivec_shape": k1_ivec, "stream_shape": k1_stream,
                     "stream_chain_shape": k1_stream_chain},
          "mfcc": {"shape": [n, w], "route": mfcc_route(w),
                   "max_abs_err": k2_err, "tolerance": MFCC_TOL,
                   "max_abs_err_vs_float64_plain": k2_err64, "tolerance_float64": MFCC_TOL64,
                   "kernel_ms": k2_ms, "plain_ms": k2_plain_ms, "library_ms": None,
                   "rfft_only_ms": k2_rfft_ms,
                   "rfft_only": "torch.fft.rfft of the same frames in fp32: the spectrum "
                                "alone, not the function",
                   "bound_ms": k2_bound_ms,
                   "bound_by": "operations" if k2_ops_ms >= k2_bytes_ms else "bytes",
                   "bound_basis": "bytes at 3.35 TB/s, or fp64 FFT operations at 34 TFLOP/s",
                   "ops_ms": k2_ops_ms, "bytes_ms": k2_bytes_ms, "flops": k2_flops,
                   "bytes": k2_bytes, "dense_dft_3xtf32_ms": k2_dense_ms,
                   "w512": {"shape": [n16, 512], "kernel_ms": k2_512_ms,
                            "bound_ms": k2_512_bound_ms},
                   "w400_dft_route_ms": k2_400_ms,
                   "fp32_plain_vs_float64_where_fp32_not_checked": k2_plain_own,
                   "smem_bytes_by_window": k2_smem,
                   "check_launches_by_route": k2_check_routes,
                   "vtln_warped_tables": k2_vtln},
          "timing": "mean of back-to-back launches, inputs resident in L2",
          "refusals": refusals,
          "check_launches": {"gather": batched_table_gather.launches,
                             "mfcc": fused_mfcc_from_frames.launches}})

    if args.only in ("cli", "cli_lattice", "cli_train", "cli_nnet3", "sgmm2", "cli_spkid"):
        run_cli(*minilib.training_set(minilib.MinilibOptions()),
                lattice=args.only == "cli_lattice", train=args.only == "cli_train",
                nnet3=args.only == "cli_nnet3", sgmm=args.only == "sgmm2",
                spkid=args.only == "cli_spkid")
        emit({"phase": "total", "card": card, "partial": args.only,
              "seconds": round(time.perf_counter() - t_start, 1)})
        return 0
    if args.only == "cli_kws":
        res = cli_kws(torch, np, argparse.Namespace(
            dev=dev, card=card, emit=emit, minilib=minilib, system=system, lattices=None,
            zero_counts=zero_counts, read_counts=read_counts))
        if res["faults"]:
            raise RuntimeError("cli_kws: " + "; ".join(res["faults"]))
        emit({"phase": "total", "card": card, "partial": args.only,
              "seconds": round(time.perf_counter() - t_start, 1)})
        return 0

    # ---- phase 3: the acoustic model on one chunk ----------------------------
    feats = minilib.compute_feats(
        {k: system.test_waves[k] for k in keys}, device=dev)
    _, padded, nf = pad_feature_batch(feats)
    tb = -(-padded.shape[1] // 128) * 128
    padded = np.pad(padded, ((0, 0), (0, tb - padded.shape[1]), (0, 0)))
    x = torch.from_numpy(padded).to(dev)
    loglikes = system.am.loglikes_batch(x)
    torch.cuda.synchronize()
    if tuple(loglikes.shape) != (BATCH, tb, P) or not bool(torch.isfinite(loglikes).all()):
        raise RuntimeError(f"acoustic model output bad: {tuple(loglikes.shape)}")
    am_ms = time_ms(torch, lambda: system.am.loglikes_batch(x), reps=3, warm=1)
    emit({"phase": "am", "card": card, "shape": list(loglikes.shape),
          "finite": True, "ms": am_ms, "load_system_seconds": round(load_s, 2)})
    del loglikes

    # ---- phase 4: the main path, with the launch counts set to 0 just before -
    batched_table_gather.launches = 0
    fused_mfcc_from_frames.launches = 0
    fused_mfcc_from_frames.launches_by_route = {"fft": 0, "dft": 0}
    gmm_loglikes.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stages = {}
    wer, audio_s = minilib.decode_and_score(
        system, beam=BEAM, max_active=MAX_ACTIVE,
        acoustic_scale=ACOUSTIC_SCALE, batch=BATCH, timings=stages)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k1_launches = batched_table_gather.launches
    k2_launches = fused_mfcc_from_frames.launches
    k2_routes = dict(fused_mfcc_from_frames.launches_by_route)
    k3_tdnn_launches = gmm_loglikes.launches
    emit({"phase": "decode", "card": card, "utterances": len(system.test_waves),
          "max_active": MAX_ACTIVE, "batch": BATCH, "beam": BEAM,
          "acoustic_scale": ACOUSTIC_SCALE, "wer_percent": wer,
          "audio_seconds": audio_s, "wall_seconds": wall_s,
          "audio_seconds_per_second": audio_s / wall_s, **stages,
          "search_ms_per_frame":
              1e3 * stages["search_seconds"] / stages["search_frames"],
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "gather_launches": k1_launches, "mfcc_launches": k2_launches,
          "mfcc_launches_by_route": k2_routes})
    if not (k1_launches > 0 and k2_launches > 0):
        raise RuntimeError("the main path did not go through both kernels: "
                           f"gather {k1_launches}, mfcc {k2_launches}")
    if k2_routes["fft"] != k2_launches:
        raise RuntimeError(f"the TDNN front end left the fft route: {k2_routes}")
    if not (wer <= MAX_WER_PERCENT):
        raise RuntimeError(f"WER {wer:.2f}% exceeds {MAX_WER_PERCENT}%")

    # ---- phase 5: K3 against its plain version ------------------------------
    # at the GMM path's shape (the 256 held-out utterances' real features,
    # padded into one batch as decode_dataset pads them, against tri.mdl), on
    # a random model with an odd pdf count and 1-150 Gaussians, on a model
    # whose 300- and 130-Gaussian pdfs run over several tiles (the carry),
    # and at N = 1, 45 and 129 (the edges of a 128-frame block).
    # It runs after the TDNN decode: its GBs of tensors and the 2,000-pdf
    # model would otherwise be in the process while the TDNN path is timed.
    gmm_model = convert.load_am_gmm_model("exp/minilib/tri.mdl", device=dev)
    gw = gmm_model.am.weights()
    _, gpad, _ = pad_feature_batch(minilib.compute_feats(system.test_waves, device=dev))
    gx = torch.from_numpy(gpad.reshape(-1, gpad.shape[-1])).to(dev)
    rnd = random_gmm(np, convert, dev, 999, gx.shape[1], seed=3)
    rx = 3.0 * torch.randn((4099, gx.shape[1]), device="cuda", generator=gen)
    span = gmm_from_mix(np, convert, dev, [3, 300, 2, 64, 1, 63, 5, 130, 7],
                        gx.shape[1], np.random.default_rng(4))
    sx = 3.0 * torch.randn((333, gx.shape[1]), device="cuda", generator=gen)
    k3_err, k3_share = check_gmm(
        torch, gmm_loglikes, gmm_loglikes_plain,
        [(gx, gw), (rx, rnd.weights()), (sx, span.weights())]
        + [(gx[:n].contiguous(), gw) for n in (1, 45, 129)])
    wide = gmm_from_mix(np, convert, dev, [2, 3], 48, np.random.default_rng(5))
    k3_refusals = check_gmm_refusals(torch, gmm_loglikes, gx[:64].contiguous(), gw,
                                     wide.weights())
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    k3_ms = time_ms(torch, lambda: gmm_loglikes(gx, gw), reps=20, plug=plug)
    k3_plain_ms = time_ms(torch, lambda: gmm_loglikes_plain(gx, gw), reps=2,
                          warm=1, plug=plug)
    # yardstick: the product alone, [N, K] frame rows by the packed
    # [columns, K] rows in fp32 (cuBLAS, TF32 off), without the logsumexp
    n3, d3 = gx.shape
    ext = torch.zeros((n3, gw.depth), device="cuda")
    ext[:, :d3], ext[:, d3:2 * d3], ext[:, 2 * d3] = gx, gx * gx, 1.0
    cols_t = sum(gw.columns()).T.contiguous()
    k3_product_ms = time_ms(torch, lambda: torch.matmul(ext, cols_t), reps=20, plug=plug)
    del ext, cols_t
    k3_flops = 2 * n3 * gw.num_gauss * (2 * d3 + 1)
    k3_bytes = 4 * (n3 * d3 + n3 * gw.num_pdfs) + sum(
        t.numel() * t.element_size()
        for t in (gw.tiles, gw.segments, gw.seg_offsets, gw.work, gw.work_offsets))
    k3_ops_ms = 1e3 * TF32_SPLIT_PRODUCTS * k3_flops / H100_TF32_FLOPS
    k3_fp32_ms = 1e3 * k3_flops / H100_FP32_FLOPS
    k3_bytes_ms = 1e3 * k3_bytes / H100_HBM_BYTES_PER_S
    emit({"phase": "gmm_kernel", "card": card,
          "shape": {"frames": n3, "dim": d3, "pdfs": gw.num_pdfs,
                    "gaussians": gw.num_gauss, "tiles": gw.num_tiles,
                    "depth": gw.depth, "padded_mixtures": gw.max_mix},
          "max_abs_err": k3_err, "worst_share_of_tolerance": k3_share,
          "tolerance": f"{GMM_TOL[0]} + {GMM_TOL[1]}*|plain|",
          "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
          "plain_timing": f"chunked plain version over all {n3} frames",
          "library_ms": None,
          "product_only_ms": k3_product_ms,
          "product_only": "torch.matmul of the [N, K] frame rows by the packed "
                          "[columns, K] rows in fp32: the product alone, not the function",
          "bound_ms": max(k3_ops_ms, k3_bytes_ms),
          "bound_by": "operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
          "bound_basis": "3xTF32 products at 495 TFLOP/s, or bytes at 3.35 TB/s",
          "ops_ms": k3_ops_ms, "bytes_ms": k3_bytes_ms, "fp32_cuda_cores_ms": k3_fp32_ms,
          "flops": k3_flops, "bytes": k3_bytes, "refusals": k3_refusals,
          "ptxas_by_depth": ptxas_by_depth(_build.build_logs().get("gmm", "")),
          "check_launches": gmm_loglikes.launches})
    del plug, rnd, rx, span, sx, wide, gx, gpad
    torch.cuda.empty_cache()

    # ---- phase 6: the GMM path, with the launch counts set to 0 just before --
    if not np.array_equal(gmm_model.tm.tid_to_pdf_array()[system.csr.tid], system.csr.pdf):
        raise RuntimeError("tri.mdl's tid -> pdf map is not the graph's")
    batched_table_gather.launches = 0
    fused_mfcc_from_frames.launches = 0
    fused_mfcc_from_frames.launches_by_route = {"fft": 0, "dft": 0}
    gmm_loglikes.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gmm_feats = minilib.compute_feats(system.test_waves, device=dev)
    torch.cuda.synchronize()
    gstages = {"features_seconds": time.perf_counter() - t0}
    failed = []
    ghyps = decode.decode_dataset(gmm_model, system.csr, system.words, gmm_feats,
                                  decode.DecodeOptions(), timings=gstages,
                                  failed=failed)
    gstats = decode.score_hyps(system.test_text, ghyps)
    torch.cuda.synchronize()
    gwall_s = time.perf_counter() - t0
    gframes = max(f.shape[0] for f in gmm_feats.values())
    g_launches = {"gather": batched_table_gather.launches,
                  "mfcc": fused_mfcc_from_frames.launches,
                  "gmm": gmm_loglikes.launches}
    g_routes = dict(fused_mfcc_from_frames.launches_by_route)
    dopts = decode.DecodeOptions()
    emit({"phase": "decode_gmm", "card": card, "model": "exp/minilib/tri.mdl",
          "utterances": len(gmm_feats), "frames_padded": gframes,
          "frames": sum(f.shape[0] for f in gmm_feats.values()),
          "beam": dopts.beam, "max_active": dopts.max_active,
          "acoustic_scale": dopts.acoustic_scale,
          "wer_percent": gstats.wer, "errors": gstats.errors,
          "words": gstats.ref_len, "failed_utterances": len(failed),
          "audio_seconds": audio_s, "wall_seconds": gwall_s, **gstages,
          "search_ms_per_frame": 1e3 * gstages["search_seconds"] / gframes,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": g_launches, "mfcc_launches_by_route": g_routes})
    if not (g_launches["gmm"] > 0 and g_launches["mfcc"] > 0):
        raise RuntimeError(f"the GMM path did not go through its kernels: {g_launches}")
    if g_routes["fft"] != g_launches["mfcc"]:
        raise RuntimeError(f"the GMM front end left the fft route: {g_routes}")
    if failed:
        raise RuntimeError(f"{len(failed)} utterances failed to decode: {failed[:8]}")
    if gstats.errors > GMM_MAX_ERRORS:
        raise RuntimeError(f"GMM WER {gstats.wer:.3f}% ({gstats.errors} errors) "
                           f"exceeds {GMM_MAX_ERRORS} errors")
    del gmm_feats
    torch.cuda.empty_cache()

    def hold_to_cpu_errors(name, stats):
        """the JAX package's errors and utterances with errors on the CPU"""
        errors, utts = IVEC_CPU_ERRORS[name]
        if (stats["errors"], stats["utterances_with_errors"]) != (errors, utts):
            raise RuntimeError(
                f"{name}: {stats['errors']} errors in {stats['utterances_with_errors']}, "
                f"the JAX package on the CPU {errors} in {utts}")

    # ---- phase 7: the chain path, with the launch counts set to 0 just before
    zero_counts()
    t0 = time.perf_counter()
    cstages = {}
    cwer, _ = minilib.decode_and_score_chain(
        chain, beam=BEAM, max_active=CHAIN_MAX_ACTIVE, batch=CHAIN_BATCH, timings=cstages)
    torch.cuda.synchronize()
    cwall_s = time.perf_counter() - t0
    cstats = dict(minilib.decode_and_score_chain.last_stats)
    c_launches = read_counts("decode_chain")
    emit({"phase": "decode_chain", "card": card, "model": "exp/minilib/chain.mdl",
          "graph": {"states": chain.csr.num_states, "arcs": chain.csr.num_arcs,
                    "eps_depth": chain.csr.eps_depth, "tiles": ctg.num_tiles},
          "utterances": len(system.test_waves), "max_active": CHAIN_MAX_ACTIVE,
          "batch": CHAIN_BATCH, "beam": BEAM, "acoustic_scale": 1.0,
          "frame_subsampling_factor": chain.model.frame_subsampling_factor,
          "wer_percent": cwer, "errors": cstats["errors"],
          "ref_words": cstats["ref_words"],
          "utterances_with_errors": cstats["utterances_with_errors"],
          "audio_seconds": audio_s, "wall_seconds": cwall_s,
          "audio_seconds_per_second": audio_s / cwall_s, **cstages,
          "search_ms_per_frame": 1e3 * cstages["search_seconds"] / cstages["search_frames"],
          "load_chain_system_seconds": chain_load_s,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "gather_launches": c_launches["gather"], "mfcc_launches": c_launches["mfcc"],
          "mfcc_launches_by_route": c_launches["mfcc_by_route"]})
    if not (c_launches["gather"] > 0 and c_launches["mfcc"] > 0):
        raise RuntimeError(f"the chain path did not go through both kernels: {c_launches}")
    if not (cwer <= MAX_WER_PERCENT):
        raise RuntimeError(f"chain WER {cwer:.2f}% exceeds {MAX_WER_PERCENT}%")

    # ---- phase 8: chain lattices (the split-eps lattice mode) on 16 utterances
    # spread over the durations, counts set to 0 just before
    cfeats = minilib.compute_feats(system.test_waves, device=dev)
    by_dur = sorted(cfeats, key=lambda k: cfeats[k].shape[0])
    lkeys = by_dur[::len(by_dur) // CHAIN_LATTICE_UTTS][:CHAIN_LATTICE_UTTS]
    fsf = chain.model.frame_subsampling_factor
    lkeys, lpad, lnf = pad_feature_batch({k: cfeats[k] for k in lkeys})
    tb = -(-lpad.shape[1] // (128 * fsf)) * (128 * fsf)
    lpad = np.pad(lpad, ((0, 0), (0, tb - lpad.shape[1]), (0, 0)))
    del cfeats
    zero_counts()
    t0 = time.perf_counter()
    lstages = {}
    lres = decode_batch_tokens(
        chain.csr, chain.model.am.logits(lpad, output_stride=fsf), (lnf + fsf - 1) // fsf,
        ViterbiOptions(beam=BEAM, max_active=CHAIN_MAX_ACTIVE, acoustic_scale=1.0),
        want_lattice=True, lattice_beam=8.0, timings=lstages)
    torch.cuda.synchronize()
    lwall_s = time.perf_counter() - t0
    l_launches = batched_table_gather.launches
    t0 = time.perf_counter()
    lat_mismatch, lat_arcs = [], 0
    for k, r in zip(lkeys, lres):
        lat = None if r is None else lattice_from_token_records(chain.csr, r.token_lattice)
        words = None if lat is None else lattice_best_path(lat, 1.0, 1.0)[0]
        lat_arcs += 0 if lat is None else lat.num_arcs
        if r is None or words != r.words:
            lat_mismatch.append(k)
    emit({"phase": "decode_chain_lattice", "card": card, "utterances": len(lkeys),
          "frames_subsampled": int(((lnf + fsf - 1) // fsf).max()),
          "wall_seconds": lwall_s, **lstages,
          "live_record_share": lstages["lattice_records_live"]
          / lstages["lattice_record_slots"],
          "overflow_fallbacks": lstages.get("lattice_overflow_fallbacks", 0),
          "lattice_build_seconds": time.perf_counter() - t0, "lattice_arcs": lat_arcs,
          "best_path_differs_from_decoder": lat_mismatch,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "gather_launches": l_launches})
    if l_launches == 0:
        raise RuntimeError("the chain lattice decode did not launch the gather kernel")
    if lat_mismatch:
        raise RuntimeError(f"rebuilt chain lattices disagree with the decoder: {lat_mismatch}")
    del lres, lpad
    torch.cuda.empty_cache()

    # ---- phase 9: rescoring, with the launch counts set to 0 just before -----
    zero_counts()
    t0 = time.perf_counter()
    rstages = {}
    rescore_lms = {}  # the two LMs, kept for lattice_outputs' big-LM decode
    full_lm = rescore_lm_future.result()  # estimated in the spawned process
    rstages["lm_wait_seconds"] = time.perf_counter() - t0
    before, after = minilib.rescore_and_score(
        system, max_active=RESCORE_MAX_ACTIVE, batch=RESCORE_BATCH, timings=rstages,
        lms=rescore_lms, full_lm=full_lm, **RESCORE)
    del full_lm
    torch.cuda.synchronize()
    rwall_s = time.perf_counter() - t0
    rstats = dict(minilib.rescore_and_score.last_stats)
    r_launches = read_counts("rescore")
    emit({"phase": "rescore", "card": card, **RESCORE, "max_active": RESCORE_MAX_ACTIVE,
          "batch": RESCORE_BATCH, "lattice_beam": 8.0,
          "wer_before": before, "wer_after": after, "wer_oracle": rstats["oracle_wer"],
          "wall_seconds": rwall_s, **rstages,
          "live_record_share": rstages["lattice_records_live"]
          / rstages["lattice_record_slots"],
          "overflow_fallbacks": rstages.get("lattice_overflow_fallbacks", 0),
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "gather_launches": r_launches["gather"], "mfcc_launches": r_launches["mfcc"],
          "mfcc_launches_by_route": r_launches["mfcc_by_route"]})
    if not (r_launches["gather"] > 0 and r_launches["mfcc"] > 0):
        raise RuntimeError(f"the rescore path did not go through both kernels: {r_launches}")
    if not (after <= before + 1.0 and rstats["oracle_wer"] <= before + 1e-9):
        raise RuntimeError(f"rescoring broke its invariants: before {before}, after "
                           f"{after}, oracle {rstats['oracle_wer']}")
    # each utterance's live records against the port's on the CPU
    live = rstats["live_records"]
    rkeys = sorted(system.test_waves)[:RESCORE["num_utts"]]
    card_live = [live.get(k) for k in rkeys]
    differing = [k for k, c, w in zip(rkeys, card_live, RESCORE_CPU_LIVE_RECORDS) if c != w]
    emit({"phase": "rescore_live_records", "card": card,
          "utterances": rkeys, "card_live_records": card_live,
          "cpu_live_records": RESCORE_CPU_LIVE_RECORDS,
          "card_total": sum(c or 0 for c in card_live),
          "cpu_total": sum(RESCORE_CPU_LIVE_RECORDS),
          "differing": {k: [live.get(k), RESCORE_CPU_LIVE_RECORDS[rkeys.index(k)]]
                        for k in differing}})
    # where a count differs, the card's search once more on the CPU's loglikes
    t0 = time.perf_counter()
    trace = rescore_trace(torch, np, minilib, decode_batch_tokens, ViterbiOptions,
                          pad_feature_batch, AmNnet, system, differing, dev
                          ) if differing else {}
    emit({"phase": "rescore_trace", "card": card, "by_utterance": trace,
          "seconds": time.perf_counter() - t0})
    for k, t in trace.items():
        if t["card_search_on_cpu_loglikes"] != t["cpu_search_on_cpu_loglikes"]:
            raise RuntimeError(f"{k}: the card's search keeps "
                               f"{t['card_search_on_cpu_loglikes']} records on the CPU's "
                               f"loglikes, the CPU's {t['cpu_search_on_cpu_loglikes']}")
        if t["card_search_on_card_loglikes"] != live.get(k):
            raise RuntimeError(f"{k}: alone it keeps {t['card_search_on_card_loglikes']} "
                               f"records, in its batch {live.get(k)}")
    torch.cuda.empty_cache()

    # ---- phases 10-11: the iVector systems, counts set to 0 just before each
    def ivector_phase(name, model, decode, target, **kw):
        zero_counts()
        t0 = time.perf_counter()
        stages = {}
        wer, _ = decode(target, beam=BEAM, max_active=IVEC_MAX_ACTIVE, batch=IVEC_BATCH,
                        timings=stages, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(name)
        emit({"phase": name, "card": card, "model": model,
              "utterances": len(system.test_waves), "max_active": IVEC_MAX_ACTIVE,
              "batch": IVEC_BATCH, "beam": BEAM, "acoustic_scale": 1.0,
              "wer_percent": wer,
              **{k: v for k, v in decode.last_stats.items() if k != "wer"},
              "audio_seconds": audio_s, "wall_seconds": wall,
              "audio_seconds_per_second": audio_s / wall, **stages,
              "ivector_share_of_wall": stages["ivector_seconds"] / wall,
              "search_ms_per_frame": 1e3 * stages["search_seconds"] / stages["search_frames"],
              "load_ivector_systems_seconds": ivec_load_s,
              "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
              "gather_launches": launches["gather"], "mfcc_launches": launches["mfcc"],
              "mfcc_launches_by_route": launches["mfcc_by_route"]})
        if not (launches["gather"] > 0 and launches["mfcc"] > 0):
            raise RuntimeError(f"{name} did not go through both kernels: {launches}")
        if not (wer <= MAX_WER_PERCENT):
            raise RuntimeError(f"{name}: WER {wer:.2f}% exceeds {MAX_WER_PERCENT}%")
        hold_to_cpu_errors(name, decode.last_stats)
        return launches

    iv_launches = ivector_phase("decode_ivec", "exp/minilib/final_ivec.am + final.ie",
                                minilib.decode_and_score, system, use_ivectors=True)
    civ_launches = ivector_phase("decode_chain_ivec", "exp/minilib/chain_ivec.mdl + final.ie",
                                 minilib.decode_and_score_chain, chain_iv)

    # ---- phases 12-13: streaming, TDNN and chain, on 8 utterances spread
    # over the durations; the batch decode's words first, then the counts
    # set to 0 just before the front end and the streaming loop
    by_dur = sorted(system.test_waves, key=lambda k: len(system.test_waves[k]))
    skeys = by_dur[::len(by_dur) // STREAM_UTTS][:STREAM_UTTS]
    swaves = {k: system.test_waves[k] for k in skeys}
    saudio_s = sum(len(w) for w in swaves.values()) / minilib.SAMP_FREQ
    s_launches = {}
    for name, dec, batch_words in (
            ("stream", sdec, lambda: minilib.decode_test_set(
                system, swaves, BEAM, STREAM_MAX_ACTIVE, 1.0, batch=STREAM_UTTS)),
            ("stream_chain", cdec, lambda: minilib.decode_chain_test_set(
                chain, swaves, BEAM, STREAM_MAX_ACTIVE, batch=STREAM_UTTS))):
        want = batch_words()
        zero_counts()
        sfeats = minilib.compute_feats(swaves, device=dev)
        got, wall, frames = stream_words(torch, dec, sfeats, dec.chunk_quantum)
        s_launches[name] = read_counts(name)
        words = chain.words if dec is cdec else system.words
        differ = sorted(k for k in skeys if [words[w] for w in got[k]] != want[k])
        sstats = compute_wer({k: list(system.test_text[k]) for k in skeys},
                             {k: [words[w] for w in got[k]] for k in skeys})
        emit({"phase": name, "card": card, "utterances": skeys,
              "graph_states": dec.graph.num_states, "max_active": STREAM_MAX_ACTIVE,
              "beam": BEAM, "chunk_frames": dec.chunk_quantum,
              "frame_subsampling_factor": dec.fsf, "window_frames": dec.window_frames,
              "audio_seconds": saudio_s, "stream_wall_seconds": wall,
              "single_stream_rtf": wall / saudio_s, "search_frames": frames,
              "ms_per_search_frame": 1e3 * wall / frames,
              "wer_percent": sstats.wer, "utterances_differing_from_batch": differ,
              "gather_launches": s_launches[name]["gather"],
              "mfcc_launches": s_launches[name]["mfcc"],
              "mfcc_launches_by_route": s_launches[name]["mfcc_by_route"]})
        if s_launches[name]["gather"] != frames or s_launches[name]["mfcc"] == 0:
            raise RuntimeError(f"{name}: {s_launches[name]} launches for {frames} "
                               "search frames (one gather a frame expected)")
        if differ:
            raise RuntimeError(f"{name}: {len(differ)} utterances differ from the "
                               f"batch decode: {differ}")

    # ---- phase 14: online2, audio in 0.5 s pieces through the feature
    # pipeline with online iVectors into the streaming decoder with the
    # CE+iVec model; counts set to 0 just before, and read just after, the
    # chunked loop (the whole-stream pipelines that check it come after)
    odec = stream_decoder(system.csr, ivec_am, tid_to_phone, STREAM_CHUNK)
    zero_counts()
    owords, ofeats, owall, opipe, ocalls = {}, {}, 0.0, 0.0, 0
    for k in skeys:
        w = swaves[k]
        pipe = OnlineFeaturePipeline(
            opts8, ivector_extractor=OnlineIvectorExtractor(ivec_ext), device=dev)
        odec.reset()
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, len(w) + ONLINE2_CHUNK_SAMPLES, ONLINE2_CHUNK_SAMPLES):
            t1 = time.perf_counter()
            last = lo >= len(w)
            f = pipe.input_finished() if last else pipe.accept_waveform(
                w[lo: lo + ONLINE2_CHUNK_SAMPLES])
            opipe += time.perf_counter() - t1
            ocalls += 1
            outs.append(f)
            odec.advance(f, final=last)
        owords[k] = [system.words[i] for i in odec.best_words()]
        owall += time.perf_counter() - t0
        ofeats[k] = np.concatenate(outs)
    o_launches = read_counts("online2")
    ofeat_err = 0.0
    for k in skeys:
        whole = OnlineFeaturePipeline(
            opts8, ivector_extractor=OnlineIvectorExtractor(ivec_ext), device=dev)
        wf = np.concatenate([whole.accept_waveform(swaves[k]), whole.input_finished()])
        if ofeats[k].shape != wf.shape:
            raise RuntimeError(f"online2 {k}: chunked features {ofeats[k].shape}, "
                               f"whole {wf.shape}")
        ofeat_err = max(ofeat_err, float(np.abs(ofeats[k] - wf).max()))
    ostats = compute_wer({k: list(system.test_text[k]) for k in skeys}, owords)
    odiffer = sorted(k for k in skeys if " ".join(owords[k]) != ONLINE2_CPU_WORDS[k])
    emit({"phase": "online2", "card": card, "utterances": len(skeys),
          "chunk_samples": ONLINE2_CHUNK_SAMPLES, "audio_seconds": saudio_s,
          "wall_seconds": owall, "single_stream_rtf": owall / saudio_s,
          "feature_pipeline_seconds": opipe, "feature_pipeline_share": opipe / owall,
          "pipeline_calls": ocalls,
          "wer_percent": ostats.wer, "errors": ostats.errors,
          "utterances_differing_from_cpu_words": odiffer,
          "max_abs_chunked_vs_whole_features": ofeat_err,
          "tolerance": PIPELINE_TOL,
          "gather_launches": o_launches["gather"], "mfcc_launches": o_launches["mfcc"],
          "mfcc_launches_by_route": o_launches["mfcc_by_route"]})
    if not (o_launches["gather"] > 0 and o_launches["mfcc"] > 0):
        raise RuntimeError(f"online2 did not go through both kernels: {o_launches}")
    if not ofeat_err <= PIPELINE_TOL:
        raise RuntimeError(f"online2: chunked features off the whole stream's by {ofeat_err}")
    if odiffer:
        raise RuntimeError(f"online2: {len(odiffer)} utterances differ from the CPU's "
                           f"words: {odiffer}")
    del odec, sdec, cdec
    torch.cuda.empty_cache()

    # ---- phases 15-17: forced alignment of the 600-utterance training set
    # (waveform → features through K2 → loglikes through K3 → per-utterance
    # training graphs → the alignment scan, K1 three times a frame) with
    # tri.mdl, mono.mdl and as the equal alignment; counts set to 0 just
    # before each, features included
    topts = minilib.MinilibOptions()
    chain_topts = dataclasses.replace(topts, chain_epochs=CHAIN_EPOCHS)
    twaves, ttext = minilib.training_set(topts)
    taudio_s = sum(len(w) for w in twaves.values()) / minilib.SAMP_FREQ
    t0 = time.perf_counter()
    lang = minilib.make_lang(topts)
    lang_s = time.perf_counter() - t0
    a_launches, a_results, a_differ = {}, {}, {}
    for name, model, equal, committed in (
            ("align_tri", "tri", False, "tri_ali.pkl"),
            ("align_mono", "mono", False, "mono_ali.pkl"),
            ("align_equal", "mono", True, "mono_ali.pkl")):
        zero_counts()
        gmm_loglikes.launches = 0
        t0 = time.perf_counter()
        tfeats = minilib.compute_feats(twaves, device=dev)
        torch.cuda.synchronize()
        fe_s = time.perf_counter() - t0
        res = minilib.align_training_set("exp/minilib", tfeats, ttext, model=model,
                                         equal=equal, lang=lang, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(name)
        launches["gmm"] = gmm_loglikes.launches
        keys = sorted(tfeats)
        got = [ali_digest(res.alignments.get(k)) for k in keys]
        want = cpu_digests(name)
        differ = [k for k, g, w in zip(keys, got, want) if g != w]
        frames = sum(f.shape[0] for f in tfeats.values())
        tid2pdf = convert.load_am_gmm_model(f"exp/minilib/{model}.mdl",
                                            device="cpu").tm.tid_to_pdf_array()
        same, compared = alignment_agreement(
            np, res.alignments, convert.load_pickle(f"exp/minilib/{committed}"), tid2pdf,
            tid2pdf)
        emit({"phase": name, "card": card, "model": f"exp/minilib/{model}.mdl",
              "equal_alignment": equal, "utterances": len(keys), "frames": frames,
              "failures": len(res.failed), "cpu_failures": want.count(FAILED_DIGEST),
              "frames_scanned": res.frames_scanned, "audio_seconds": taudio_s,
              "wall_seconds": wall, "front_end_seconds": fe_s, "lang_build_seconds": lang_s,
              **res.seconds,
              "align_audio_seconds_per_second": taudio_s / res.seconds["align_seconds"],
              "utterances_differing_from_cpu": differ,
              f"pdf_agreement_with_{committed}": same / max(compared, 1),
              "frames_compared_with_committed": compared,
              "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
              "gather_launches": launches["gather"], "mfcc_launches": launches["mfcc"],
              "gmm_launches": launches["gmm"],
              "mfcc_launches_by_route": launches["mfcc_by_route"]})
        if launches["gather"] != 3 * res.frames_scanned:
            raise RuntimeError(f"{name}: {launches['gather']} gather launches for "
                               f"{res.frames_scanned} frames (three a frame expected)")
        if launches["mfcc"] == 0 or (launches["gmm"] == 0) != equal:
            raise RuntimeError(f"{name} did not go through its kernels: {launches}")
        if len(res.failed) != want.count(FAILED_DIGEST):
            raise RuntimeError(f"{name}: {len(res.failed)} failures, the CPU "
                               f"{want.count(FAILED_DIGEST)}")
        a_launches[name], a_results[name], a_differ[name] = launches, res, differ
        del tfeats
    torch.cuda.empty_cache()

    # ---- phase 18: where an utterance's tids differ from the CPU's, its
    # loglikes computed on the CPU, aligned on both devices: they must agree
    trace = {}
    t0 = time.perf_counter()
    for name, differ in a_differ.items():
        if not differ:
            continue
        res = a_results[name]
        model, equal = ("tri", False) if name == "align_tri" else ("mono", name == "align_equal")
        cfeats = minilib.compute_feats({k: twaves[k] for k in differ}, device="cpu")
        ckeys, cpad, cnf = pad_feature_batch(cfeats)
        cpu_gmm = convert.load_am_gmm_model(f"exp/minilib/{model}.mdl", device="cpu")
        cll = (torch.zeros((len(ckeys), cpad.shape[1], cpu_gmm.am.num_pdfs)) if equal
               else cpu_gmm.am.loglikes_batch(torch.from_numpy(cpad)))
        vopts = ViterbiOptions(acoustic_scale=1.0 if equal else 0.1)
        graphs = [res.graphs[k] for k in ckeys]
        on_cpu = align_batch(graphs, cll, cnf, vopts, device="cpu")
        on_card = align_batch(graphs, cll.to(dev), cnf, vopts, device=dev)
        want = dict(zip(sorted(twaves), cpu_digests(name)))
        trace[name] = {k: {"card": ali_digest(res.alignments.get(k)), "cpu": want[k],
                           "cpu_search_on_cpu_loglikes": ali_digest(a),
                           "card_search_on_cpu_loglikes": ali_digest(b),
                           "scores_equal": sa == sb}
                       for k, a, b, sa, sb in zip(ckeys, on_cpu[0], on_card[0],
                                                  on_cpu[1], on_card[1])}
    emit({"phase": "align_trace", "card": card, "by_phase": trace,
          "seconds": time.perf_counter() - t0})
    for name, by_utt in trace.items():
        for k, t in by_utt.items():
            if (t["card_search_on_cpu_loglikes"] != t["cpu_search_on_cpu_loglikes"]
                    or not t["scores_equal"]):
                raise RuntimeError(f"{name} {k}: the card's alignment on the CPU's "
                                   f"loglikes is not the CPU's: {t}")

    # ---- phase 19: K1 and K3 at the alignment's shapes against their plain
    # versions: K1 on the frame's loglike row (read in place), the alpha
    # before and after it, at the padded [B, S] and [B, A] of each model's
    # graphs; K3 on the training set's padded features with tri.mdl and
    # mono.mdl (mono: 125 pdfs of more Gaussians each, another packing)
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    k1_align, k3_align = {}, {}
    tfeats = minilib.compute_feats(twaves, device=dev)
    _, tpad, tnf = pad_feature_batch(tfeats)
    tx = torch.from_numpy(tpad.reshape(-1, tpad.shape[-1])).to(dev)
    del tfeats, tpad
    ab = len(tnf)
    k1_align_err = 0.0
    for name in ("align_tri", "align_mono"):
        S, A = align_shape(list(a_results[name].graphs.values()))
        gmm_model = convert.load_am_gmm_model(
            f"exp/minilib/{'tri' if name == 'align_tri' else 'mono'}.mdl", device=dev)
        Pa = gmm_model.am.num_pdfs
        k1_align_err = max(k1_align_err, check_gather(
            torch, batched_table_gather, batched_table_gather_plain,
            [(ab, Pa, A, 3, 1), (ab, S, A, 1, 0), (ab, Pa, A - 3, 3, 2)], seed=9))
        k1_align[name] = {"loglikes": gather_at(ab, Pa, A, int(tnf.max())),
                          "alpha": gather_at(ab, S, A, 1)}
        gw_a = gmm_model.am.weights()
        k3_align[name] = k3_at(torch, gmm_loglikes, gmm_loglikes_plain, gw_a, tx, plug)
        del gmm_model, gw_a
    del plug
    torch.cuda.empty_cache()
    emit({"phase": "align_kernels", "card": card, "batch": ab,
          "gather": {"exact": k1_align_err == 0.0, "max_abs_err": k1_align_err,
                     **k1_align},
          "gmm": k3_align, "tolerance": f"{GMM_TOL[0]} + {GMM_TOL[1]}*|plain|",
          "timing": "mean of back-to-back launches, inputs resident in L2"})

    # ---- phases 20-23: GMM training.  Counts set to 0 just before each of
    # the three, read just after.  train_yesno: config 1 end to end at its
    # defaults (features of 41 utterances through K2, flat-start monophone
    # training with K3 and the alignment scan's K1 on every pass, mkgraph,
    # the decode).  train_mono / train_tri: minilib stages 3 and 4 on the
    # training set's features through K2; tri starts from the committed
    # mono.mdl and mono_ali.pkl.  Each is held to the port's CPU run
    # (*_CPU_RECORD): Gaussian counts, like/frame within TRAIN_LIKE_TOL
    def like_gaps(history, record):
        if len(history) != len(record["like_per_frame"]):
            raise RuntimeError(f"{len(history)} iterations, the CPU record "
                               f"{len(record['like_per_frame'])}")
        return [abs(h["like_per_frame"] - w)
                for h, w in zip(history, record["like_per_frame"])]

    def stage_line(t, iters, audio_s):
        """the stages' seconds (align_seconds is the scan; a pass is
        loglikes_seconds + align_seconds), per iteration, and audio-s/s"""
        align_s = t["loglikes_seconds"] + t["align_seconds"]
        return {**{k: v for k, v in t.items() if k.endswith("seconds")},
                "align_passes": t["align_passes"], "frames_scanned": t["align_frames"],
                "accumulate_seconds_per_iteration": t["accumulate_seconds"] / iters,
                "update_seconds_per_iteration": t["update_seconds"] / iters,
                "align_audio_seconds_per_second": t["align_passes"] * audio_s / align_s,
                "accumulate_audio_seconds_per_second":
                    iters * audio_s / t["accumulate_seconds"]}

    train_faults = []  # every training phase runs; a fault ends the run after them
    ytrain_waves, ytrain_text, _, _ = yesno.make_corpus()
    yaudio_s = sum(len(w) for w in ytrain_waves.values()) / yesno.SAMP_FREQ
    zero_counts()
    gmm_loglikes.launches = 0
    y_hist, y_tim = [], {}
    t0 = time.perf_counter()
    ystats = yesno.run_yesno(device=dev, history=y_hist, timings=y_tim)
    torch.cuda.synchronize()
    y_wall = time.perf_counter() - t0
    ty_launches = read_counts("train_yesno")
    ty_launches["gmm"] = gmm_loglikes.launches
    y_gaps = like_gaps(y_hist, YESNO_CPU_RECORD)
    emit({"phase": "train_yesno", "card": card, "wer_percent": ystats.wer,
          "errors": ystats.errors, "ref_words": ystats.ref_len, "wall_seconds": y_wall,
          **stage_line(y_tim, len(y_hist), yaudio_s),
          "gaussians": [h["gaussians"] for h in y_hist],
          "gaussians_final": y_hist[-1]["gaussians_after"],
          "like_per_frame": [h["like_per_frame"] for h in y_hist],
          "max_like_gap_to_cpu": max(y_gaps), "like_tolerance": TRAIN_LIKE_TOL,
          "gather_launches": ty_launches["gather"], "mfcc_launches": ty_launches["mfcc"],
          "gmm_launches": ty_launches["gmm"],
          "mfcc_launches_by_route": ty_launches["mfcc_by_route"]})
    if not (ystats.ref_len > 0 and ystats.wer == 0.0):
        train_faults.append(f"train_yesno: {ystats.report()}, not WER 0.00")
    if ([h["gaussians"] for h in y_hist] != YESNO_CPU_RECORD["gaussians"]
            or y_hist[-1]["gaussians_after"] != YESNO_CPU_RECORD["gaussians_final"]):
        train_faults.append("train_yesno: Gaussian counts differ from the CPU's")
    if max(y_gaps) > TRAIN_LIKE_TOL:
        train_faults.append(f"train_yesno: like/frame {max(y_gaps)} from the CPU's")
    if (ty_launches["gather"] < 3 * y_tim["align_frames"] or ty_launches["mfcc"] == 0
            or ty_launches["gmm"] <= y_tim["align_passes"]):
        train_faults.append(f"train_yesno did not go through its kernels: {ty_launches}")

    # alignment passes by the schedules: mono aligns first, at each realign
    # iteration within its 25 and last; tri starts from converted
    # alignments and realigns at 1, 3, 5, 7 and last
    mono_passes = 2 + sum(0 < r < topts.mono_iters for r in GmmTrainOptions().realign_iters)
    tri_passes = 1 + len(range(1, topts.tri_iters, 2))
    tr_launches, tr_results = {}, {}
    for name, train, record, iters, passes, committed in (
            ("train_mono", minilib.train_mono_system, MONO_CPU_RECORD,
             topts.mono_iters, mono_passes, "mono"),
            ("train_tri", minilib.train_tri_system, TRI_CPU_RECORD,
             topts.tri_iters, tri_passes, "tri")):
        zero_counts()
        gmm_loglikes.launches = 0
        t0 = time.perf_counter()
        tfeats = minilib.compute_feats(twaves, device=dev)
        torch.cuda.synchronize()
        fe_s = time.perf_counter() - t0
        res = train(None, tfeats, ttext, lang, topts, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(name)
        launches["gmm"] = gmm_loglikes.launches
        gaps = like_gaps(res.history, record)
        gauss = [h["gaussians"] for h in res.history]
        final_gauss = res.model.am.num_gauss
        # agreement with the committed alignment of the same stage: by pdf
        # (mono: the same tree), and by phone
        cmodel = convert.load_am_gmm_model(f"exp/minilib/{committed}.mdl", device="cpu")
        calis = convert.load_pickle(f"exp/minilib/{committed}_ali.pkl")
        agree = {label: (lambda sc: sc[0] / max(sc[1], 1))(alignment_agreement(
            np, res.alignments, calis, getattr(res.model.tm, f"tid_to_{label}_array")(),
            getattr(cmodel.tm, f"tid_to_{label}_array")()))
            for label in (("phone", "pdf") if name == "train_mono" else ("phone",))}
        line = {"phase": name, "card": card, "utterances": len(tfeats),
                "aligned": len(res.alignments), "audio_seconds": taudio_s,
                "wall_seconds": wall, "front_end_seconds": fe_s,
                **stage_line(res.timings, iters, taudio_s),
                "align_passes_by_schedule": passes,
                "gather_launches_expected": 3 * res.timings["align_frames"],
                "gaussians": gauss, "gaussians_final": final_gauss,
                "like_per_frame": [h["like_per_frame"] for h in res.history],
                "max_like_gap_to_cpu": max(gaps), "like_tolerance": TRAIN_LIKE_TOL,
                "largest_mixture": max(p.num_mix for p in res.model.am.pdfs),
                f"agreement_with_committed_{committed}_ali": agree,
                "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
                "gather_launches": launches["gather"], "mfcc_launches": launches["mfcc"],
                "gmm_launches": launches["gmm"],
                "mfcc_launches_by_route": launches["mfcc_by_route"]}
        if name == "train_tri":
            # the tree's leaves by the events they hold, against the CPU's
            stats = {}
            mono_tm = convert.load_am_gmm_model("exp/minilib/mono.mdl", device="cpu").tm
            for k, a in convert.load_pickle("exp/minilib/mono_ali.pkl").items():
                accumulate_tree_stats(a, tfeats[k], mono_tm, stats=stats)
            digests = leaf_digests(res.tree, stats)
            cpu_leaves = set(re.findall(".{8}", TRI_CPU_RECORD["leaf_digests"]))
            tree_s = sum(res.timings[k] for k in ("tree_stats_seconds", "tree_seconds",
                                                  "tree_init_seconds"))
            line.update({"leaves": res.tree.num_pdfs,
                         "leaves_differing_from_cpu": sum(d not in cpu_leaves
                                                          for d in digests),
                         "tree_stage_seconds": tree_s, "tree_stage_share": tree_s / wall,
                         "final_gaussians_cpu": TRI_CPU_RECORD["gaussians_final"]})
        emit(line)
        if len(res.alignments) != len(tfeats):
            train_faults.append(f"{name}: {len(res.alignments)} of {len(tfeats)} aligned")
        if max(gaps) > TRAIN_LIKE_TOL:
            train_faults.append(f"{name}: like/frame {max(gaps)} from the CPU's")
        if name == "train_mono" and (gauss != record["gaussians"]
                                     or final_gauss != record["gaussians_final"]):
            train_faults.append(f"{name}: Gaussian counts differ from the CPU's")
        if name == "train_tri" and (
                res.tree.num_pdfs != topts.tree_leaves
                or abs(final_gauss - record["gaussians_final"])
                > TRI_GAUSS_REL * record["gaussians_final"]):
            train_faults.append(f"{name}: {res.tree.num_pdfs} leaves, {final_gauss} "
                                f"Gaussians (the CPU {record['gaussians_final']})")
        if (res.timings["align_passes"] != passes
                or launches["gather"] != 3 * res.timings["align_frames"]
                or launches["gmm"] != passes or launches["mfcc"] == 0):
            train_faults.append(f"{name}: launches {launches} for "
                                f"{res.timings['align_passes']} passes of "
                                f"{res.timings['align_frames']} frames")
        tr_launches[name], tr_results[name] = launches, res
        del tfeats
    torch.cuda.empty_cache()

    # ---- phase 23: one EM step from the same inputs on both devices (the
    # committed mono.mdl and mono_ali.pkl, the features computed on the CPU):
    # the statistics, the M-step and a mixup must agree within STEP_TOL,
    # the numbers that the training phases' iterations repeat; and the
    # card's statistics, taken twice, must be the same bits
    cfeats = minilib.compute_feats(twaves, device="cpu")
    mono_ali = convert.load_pickle("exp/minilib/mono_ali.pkl")
    skeys = sorted(mono_ali)
    sframes = torch.from_numpy(np.concatenate([cfeats[k] for k in skeys]))
    sali = np.concatenate([np.asarray(mono_ali[k], np.int64) for k in skeys])
    del cfeats
    step = {}
    for where in ("cpu", "cuda"):
        m = convert.load_am_gmm_model("exp/minilib/mono.mdl", device=where)
        t0 = time.perf_counter()
        acc = AccumAmDiagGmm(m.am)
        like = acc.accumulate_corpus(m.am, sframes.to(where), m.tm.tid_to_pdf_array()[sali])
        torch.cuda.synchronize()
        acc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        new = mle_am_diag_gmm_update(m.am, acc)
        new = mixup(new, new.num_gauss + 18, occs=acc.pdf_occupancy(), seed=0)
        torch.cuda.synchronize()
        step[where] = {"accs": [t.cpu().numpy() for t in (acc.occ, acc.mean_acc, acc.var_acc)],
                       "like": like, "model": new, "accumulate_seconds": acc_s,
                       "update_seconds": time.perf_counter() - t0}
    # the card's statistics once more: they must repeat bit for bit
    again = AccumAmDiagGmm(m.am)
    again_like = again.accumulate_corpus(m.am, sframes.to("cuda"), m.tm.tid_to_pdf_array()[sali])
    repeats = again_like == step["cuda"]["like"] and all(
        np.array_equal(t.cpu().numpy(), a)
        for t, a in zip((again.occ, again.mean_acc, again.var_acc), step["cuda"]["accs"]))
    del again, m
    sc, sg = step["cpu"], step["cuda"]
    acc_gap = max(float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-300))
                  for g, c in zip(sg["accs"], sc["accs"]))
    like_gap = abs(sg["like"] - sc["like"]) / abs(sc["like"])
    same_mix = ([p.num_mix for p in sg["model"].pdfs] == [p.num_mix for p in sc["model"].pdfs])
    param_gap = max(float(np.abs(getattr(g, f) - getattr(c, f)).max()
                          / max(np.abs(getattr(c, f)).max(), 1e-300))
                    for g, c in zip(sg["model"].pdfs, sc["model"].pdfs)
                    for f in ("weights", "means", "vars")) if same_mix else None
    emit({"phase": "train_step", "card": card, "frames": int(sframes.shape[0]),
          "model": "exp/minilib/mono.mdl", "alignment": "exp/minilib/mono_ali.pkl",
          "stats_gap_relative_to_largest": acc_gap, "like_gap_relative": like_gap,
          "same_gaussian_counts": same_mix, "param_gap_relative_to_largest": param_gap,
          "tolerance": STEP_TOL, "card_statistics_repeat_bit_for_bit": repeats,
          "accumulate_seconds": {"card": sg["accumulate_seconds"],
                                 "cpu": sc["accumulate_seconds"]},
          "update_seconds": {"card": sg["update_seconds"], "cpu": sc["update_seconds"]}})
    if not (same_mix and max(acc_gap, like_gap, param_gap) <= STEP_TOL and repeats):
        train_faults.append("train_step: one EM step on the card differs from the CPU's "
                            "or from itself")
    del step, sc, sg, sframes

    # ---- phase 24: the kernels at the training shapes.  K3 on the training
    # set's padded frames with the flat-start mono model (one Gaussian a
    # pdf), the trained mono and tri models, and the largest mixture of
    # either alone; K1 at the yesno alignment's shapes (loglike row, alpha);
    # K2 on the yesno training waves' frames
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    tfeats = minilib.compute_feats(twaves, device=dev)
    allf = np.concatenate([tfeats[k] for k in sorted(tfeats)])
    flat = AmDiagGmm.init_mono(tr_results["train_mono"].model.am.num_pdfs, allf.mean(axis=0),
                               allf.var(axis=0) + 1e-3, perturb=0.01, device=dev)
    del tfeats, allf
    biggest = max((p for r in tr_results.values() for p in r.model.am.pdfs),
                  key=lambda p: p.num_mix)
    k3_train = {}
    for name, am in (("flat_start_mono", flat),
                     ("trained_mono", tr_results["train_mono"].model.am),
                     ("trained_tri", tr_results["train_tri"].model.am),
                     ("largest_mixture", AmDiagGmm([biggest], dev))):
        k3_train[name] = k3_at(torch, gmm_loglikes, gmm_loglikes_plain, am.weights(), tx,
                               plug)
    del tx
    ylang = yesno.make_lang()
    yphones = ylang.real_phone_ids
    ytopo = HmmTopology.standard(yphones, silence_phones=[ylang.silence_id])
    yctx = monophone_context_dependency(yphones, {p: ytopo.num_pdf_classes(p)
                                                  for p in yphones})
    ytm = TransitionModel.from_context_dependency(yctx, ytopo)
    ygraphs = GraphCompiler(ylang, yctx, ytm).compile_csr_graphs(
        [ytrain_text[k] for k in sorted(ytrain_text)])
    yS, yA = align_shape(ygraphs)
    yT = max(num_frames(len(w), opts8.frame_opts) for w in ytrain_waves.values())
    yB, yP = len(ygraphs), yctx.num_pdfs
    k1_yesno_err = check_gather(torch, batched_table_gather, batched_table_gather_plain,
                                [(yB, yP, yA, yT, 1), (yB, yS, yA, 1, 0)], seed=13)
    k1_yesno = {"loglikes": gather_at(yB, yP, yA, yT), "alpha": gather_at(yB, yS, yA, 1)}
    ykeys = sorted(ytrain_waves)
    ybatch = np.zeros((len(ykeys), max(len(w) for w in ytrain_waves.values())), np.float32)
    for i, k in enumerate(ykeys):
        ybatch[i, : len(ytrain_waves[k])] = ytrain_waves[k]
    yframes, _ = extract_frames(torch.from_numpy(ybatch).to(dev), opts8.frame_opts)
    yframes = yframes.reshape(-1, yframes.shape[-1]).contiguous()
    k2_yesno_err, k2_yesno_err64, _ = check_mfcc(
        torch, fused_mfcc_from_frames, fused_mfcc_reference, [(yframes, w8, w8d, True)])
    yn = yframes.shape[0]
    k2_yesno = {"shape": [yn, yframes.shape[1]], "max_abs_err": k2_yesno_err,
                "max_abs_err_vs_float64_plain": k2_yesno_err64,
                "kernel_ms": time_ms(torch, lambda: fused_mfcc_from_frames(yframes, w8),
                                     reps=20, plug=plug),
                "plain_ms": time_ms(torch, lambda: fused_mfcc_reference(yframes, w8),
                                    reps=5, plug=plug),
                "library_ms": None,
                "rfft_only_ms": time_ms(torch, lambda: torch.fft.rfft(yframes, dim=1),
                                        reps=20, plug=plug),
                "bytes": 4 * yn * (yframes.shape[1] + c)}
    yb_ms = 1e3 * k2_yesno["bytes"] / H100_HBM_BYTES_PER_S
    yo_ms = 1e3 * mfcc_flops(yn, yframes.shape[1], spans8, nb, c) / H100_FP64_FLOPS
    k2_yesno.update({"bound_ms": max(yb_ms, yo_ms),
                     "bound_by": "operations" if yo_ms >= yb_ms else "bytes"})
    del plug, yframes
    torch.cuda.empty_cache()
    emit({"phase": "train_kernels", "card": card,
          "gmm": k3_train, "tolerance": f"{GMM_TOL[0]} + {GMM_TOL[1]}*|plain|",
          "gather_yesno": {"exact": k1_yesno_err == 0.0, "shape_BSA": [yB, yS, yA],
                           "frames": yT, **k1_yesno},
          "mfcc_yesno": k2_yesno,
          "timing": "mean of back-to-back launches, inputs resident in L2"})
    if train_faults:
        raise RuntimeError("GMM training: " + "; ".join(train_faults))

    # ---- LDA+MLLT at minilib scale (the lda_mllt_minilib line is
    # emitted with its decode, after run_all).  Its decoding graph (an HCLG of
    # the new tree and the pruned trigram, minutes of host work in the native
    # library) builds in a process of its own while the neural phases run
    from old_kaldi_git_tpu_torch.feat.compute import FEAT_CHUNK, compute_utterance_feats
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.recipes import triphone

    cfg2_faults = []  # every config 2 phase runs; a fault ends the run after them
    # lda_mllt_minilib: train_lda_mllt at minilib scale: the 600 training
    # utterances' statics (K2), spliced to 91 dimensions, from tri.mdl and
    # tri_ali.pkl, 2,000 leaves, 40 dimensions, the tri stage's options
    # (8 iterations towards 4,000 Gaussians) with mllt_iters (2, 4, 6): 8
    # iterations in segments of 2 and 3 MLLT updates (the default (2, 4, 6,
    # 12) would run 12 iterations and 4 updates).  Held to the port's CPU
    # run (LDA_MLLT_CPU_RECORD); where it parts, the training runs once
    # more from statics computed on the CPU, to tell the front end's float
    # order from the training's.  Then the first 64 clean held-out
    # utterances decode on an HCLG of the new tree and the pruned trigram,
    # before and after per-utterance fMLLR
    lm_tri = AmGmmModel.load("exp/minilib/tri.mdl", device=dev)
    lm_tri_ali = convert.load_pickle("exp/minilib/tri_ali.pkl")
    lm_opts = GmmTrainOptions(num_iters=8, totgauss=4000)
    lm_lang = lang

    def lda_mllt_run(statics, device):
        hist, tim = [], {}
        t0 = time.perf_counter()
        res = triphone.train_lda_mllt(statics, ttext, lm_lang, lm_tri, lm_tri_ali,
                                      opts=lm_opts, device=device, history=hist,
                                      timings=tim, **LDA_MLLT_OPTS)
        torch.cuda.synchronize()
        tim["wall_seconds"] = time.perf_counter() - t0
        stats = {}
        for k, a in lm_tri_ali.items():
            accumulate_tree_stats(a, np.zeros((len(a), 1)), lm_tri.tm, stats=stats)
        digests = "".join(leaf_digests(res.ctx_dep, stats))
        rec = LDA_MLLT_CPU_RECORD
        want_t = np.frombuffer(zlib.decompress(base64.b64decode(rec["transform"])),
                               "<f4").reshape(res.transform.shape)
        sign = np.where((res.transform * want_t).sum(1, keepdims=True) < 0, -1.0, 1.0)
        gaps = [abs(h["like_per_frame"] - w) for h, w in zip(hist, rec["like_per_frame"])]
        verdict = {
            "same_leaves": digests == rec["leaf_digests"],
            "same_gaussians": ([h["gaussians"] for h in hist] == rec["gaussians"]
                               and res.model.am.num_gauss == rec["gaussians_final"]),
            "max_like_gap_to_cpu": max(gaps) if len(gaps) == len(rec["like_per_frame"])
            else None,
            "transform_gap_relative": float(np.abs(sign * res.transform - want_t).max()
                                            / np.abs(want_t).max())}
        verdict["equal_to_record"] = (
            verdict["same_leaves"] and verdict["same_gaussians"]
            and verdict["max_like_gap_to_cpu"] is not None
            and verdict["max_like_gap_to_cpu"] <= LDA_MLLT_LIKE_TOL
            and verdict["transform_gap_relative"] <= LDA_MLLT_TRANSFORM_REL)
        return res, hist, tim, verdict

    zero_counts()
    gmm_loglikes.launches = 0
    t0 = time.perf_counter()
    lm_statics = compute_utterance_feats(twaves, minilib.SAMP_FREQ, dev, deltas=False,
                                         chunk=FEAT_CHUNK)
    torch.cuda.synchronize()
    lm_stages = {"statics_seconds": time.perf_counter() - t0}
    lm_res, lm_hist, lm_tim, lm_verdict = lda_mllt_run(lm_statics, dev)
    lm_launches = read_counts("lda_mllt_minilib")
    lm_launches["gmm"] = gmm_loglikes.launches
    lm_rerun = lm_statics_cpu = None
    if not lm_verdict["equal_to_record"]:
        lm_statics_cpu = compute_utterance_feats(twaves, minilib.SAMP_FREQ,
                                                 torch.device("cpu"), deltas=False,
                                                 chunk=FEAT_CHUNK)
        _, rhist, rtim, rverdict = lda_mllt_run(lm_statics_cpu, dev)
        lm_rerun = {"statics": "CPU", **rverdict, "wall_seconds": rtim["wall_seconds"],
                    "like_per_frame": [h["like_per_frame"] for h in rhist],
                    "gaussians": [h["gaussians"] for h in rhist]}
        if not rverdict["equal_to_record"]:
            cfg2_faults.append(f"lda_mllt_minilib: parts from the CPU record on the "
                               f"card's statics {lm_verdict} and on the CPU's {rverdict}")
    graph_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    lm_graph = graph_pool.submit(decode_graph_of, lm_res.ctx_dep, lm_res.model.tm)
    del lm_statics_cpu

    # ---- phases 25-28: neural training, minilib stages 5, 7 and 8, each
    # path's launch counts set to 0 just before it and read just after.
    # train_ce: the training set's features through K2, CE training of the
    # TDNN-F final.am from tri_ali.pkl's labels (4 epochs), then the clean
    # held-out decode with the card-trained model on hclg.npz (K1, K2).
    # train_chain: the biphone chain tree, den graph and 10 LF-MMI epochs
    # (MinilibOptions' 20, cut), the model's own split-eps chain HCLG, and
    # its decode (K1, K2).
    # train_ce_step / train_chain_step: one step from the committed models'
    # parameters on the card and on the CPU, which must agree
    from old_kaldi_git_tpu_torch.chain.loss import (
        ChainLossOptions, denominator_logprob, numerator_logprob)
    from old_kaldi_git_tpu_torch.chain.supervision import (
        alignment_to_supervision, chain_xent_labels, pad_supervisions)
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs
    from old_kaldi_git_tpu_torch.models import train as nnet_train
    from old_kaldi_git_tpu_torch.recipes.chain import (
        METRICS as CHAIN_METRICS, ChainModel, chain_objective, make_chain_step)

    nnet_faults = []  # every neural phase runs; a fault ends the run after them
    zero_counts()
    t0 = time.perf_counter()
    tfeats = minilib.compute_feats(twaves, device=dev)
    torch.cuda.synchronize()
    ce_fe_s = time.perf_counter() - t0
    ce_hist, ce_tim = [], {}
    ce_am = minilib.train_am_system(None, tfeats, topts, device=dev, history=ce_hist,
                                    timings=ce_tim)
    torch.cuda.synchronize()
    ce_wall = time.perf_counter() - t0
    ce_launches = {"train": read_counts("train_ce")}
    ce_peak = torch.cuda.max_memory_allocated()
    zero_counts()
    ce_stages = {}
    ce_wer, _ = minilib.decode_and_score(
        dataclasses.replace(system, am=ce_am), beam=BEAM, max_active=MAX_ACTIVE,
        acoustic_scale=ACOUSTIC_SCALE, batch=BATCH, timings=ce_stages)
    ce_launches["decode"] = read_counts("train_ce_decode")
    ce_stats = minilib.decode_and_score.last_stats
    ce_loss = [h["loss"] for h in ce_hist]
    emit({"phase": "train_ce", "card": card, "model": "TDNN-F 39 -> 512 (bottleneck 64) "
          f"x {topts.num_layers} -> {ce_am.config.num_outputs} pdfs of tri.mdl",
          "utterances": len(tfeats), "epochs": len(ce_hist), "steps": ce_tim["steps"],
          "steps_by_epoch": [h["steps"] for h in ce_hist], "ce_by_epoch": ce_loss,
          "accuracy_by_epoch": [h["acc"] for h in ce_hist], "wall_seconds": ce_wall,
          "front_end_seconds": ce_fe_s, "train_seconds": ce_tim["train_seconds"],
          "priors_seconds": ce_tim["priors_seconds"],
          "step_ms": 1e3 * ce_tim["train_seconds"] / ce_tim["steps"],
          "steps_per_second": ce_tim["steps"] / ce_tim["train_seconds"],
          "peak_device_memory_bytes": ce_peak,
          "mfcc_launches": ce_launches["train"]["mfcc"],
          "decode": {"graph": "exp/minilib/hclg.npz", "max_active": MAX_ACTIVE,
                     "batch": BATCH, "wer_percent": ce_wer, "errors": ce_stats["errors"],
                     "ref_words": ce_stats["ref_words"],
                     "utterances_with_errors": ce_stats["utterances_with_errors"],
                     **ce_stages, "gather_launches": ce_launches["decode"]["gather"],
                     "mfcc_launches": ce_launches["decode"]["mfcc"]}})
    if not (len(ce_hist) == CE_EPOCHS and all(np.isfinite(ce_loss))
            and all(b < a for a, b in zip(ce_loss, ce_loss[1:]))):
        nnet_faults.append(f"train_ce: CE by epoch {ce_loss}, not {CE_EPOCHS} finite and "
                           "falling")
    if ce_wer > MAX_WER_PERCENT:
        nnet_faults.append(f"train_ce: WER {ce_wer} % above {MAX_WER_PERCENT} %")
    if not (ce_launches["train"]["mfcc"] > 0 and ce_launches["decode"]["gather"] > 0
            and ce_launches["decode"]["mfcc"] > 0):
        nnet_faults.append(f"train_ce did not go through its kernels: {ce_launches}")

    del tfeats
    zero_counts()
    t0 = time.perf_counter()
    tfeats = minilib.compute_feats(twaves, device=dev)
    torch.cuda.synchronize()
    ch_fe_s = time.perf_counter() - t0
    ch_hist, ch_rep = [], {}
    ch_model = minilib.train_chain_model(tfeats, lang, chain_topts, device=dev,
                                         history=ch_hist, report=ch_rep)
    torch.cuda.synchronize()
    ch_wall = time.perf_counter() - t0
    ch_launches = {"train": read_counts("train_chain")}
    ch_peak = torch.cuda.max_memory_allocated()
    del tfeats
    # stage 8's graph is host work (52-80 s): it builds in the spawned process
    # while the phases up to train_chain_ivec's training run, and
    # train_chain's decode waits for it there
    ch_graph_future = host_pool.submit(minilib.chain_graph, ch_model.ctx_dep, ch_model.tm,
                                       None, chain_topts)
    ch_objf = [h["objf"] for h in ch_hist]
    if not (len(ch_hist) == CHAIN_EPOCHS and all(np.isfinite(ch_objf))):
        nnet_faults.append(f"train_chain: objf by epoch {ch_objf}, not {CHAIN_EPOCHS} "
                           "finite")
    torch.cuda.empty_cache()

    # one step from the same inputs on both devices, the features computed
    # on the CPU: a CE step from final.am on the first 16 chunks of 16
    # utterances, a chain step from chain.mdl on 8 utterances.  Held: the
    # loss; the gradients at the committed parameters, the card's no
    # further from the CPU's float64 gradients than the CPU's own float32
    # ones (in l2, relative); the parameters after the card's optimizer
    # takes the CPU's gradients.  Recorded: the parameters after each
    # device's whole step.  Adam's first update is lr·g/(|g| + 1e-8), about
    # ±lr wherever |g| > 1e-7, so an element whose gradient lies under the
    # float32 error of its sums (a bias ahead of a batch-norm is exactly 0)
    # takes its sign from each device's order of adds
    tri = convert.load_am_gmm_model("exp/minilib/tri.mdl", device="cpu")
    tri_ali = convert.load_pickle("exp/minilib/tri_ali.pkl")
    skeys = sorted(twaves)[:16]
    sfeats = minilib.compute_feats({k: twaves[k] for k in skeys}, device="cpu")
    slabels = {k: np.asarray(alignment_to_pdfs(tri.tm, tri_ali[k]), np.int32) for k in skeys}
    bf, bl, bm = next(nnet_train._chunk_batches(sfeats, slabels, 140, 16,
                                                np.random.default_rng(0)))

    def l2_gap(a, b):
        """||a − b|| / ||b|| over every tensor of two {name: tensor} dicts"""
        num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
        return (num / sum(float((v.double() ** 2).sum()) for v in b.values())) ** 0.5

    def probe(model, loss_of):
        """the loss, metrics and gradients at a model's parameters, on a copy"""
        model = copy.deepcopy(model)
        loss, metrics = loss_of(model)
        loss.backward()
        return (loss.item(), {k: v.item() for k, v in metrics.items()},
                {k: p.grad.detach().cpu() for k, p in model.named_parameters()})

    def step_on(model, loss_of, make_step, num_steps):
        """a device's loss and gradients at the starting parameters, its
        optimizer, the starting parameters, and the parameters after the
        real step"""
        loss, metrics, grads = probe(model, loss_of)
        opt = nnet_train.make_optimizer(nnet_train.NnetTrainOptions(num_epochs=CE_EPOCHS),
                                        num_steps)
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        t0 = time.perf_counter()
        step_loss = make_step(model, opt)
        return {"loss": loss, "metrics": metrics, "grads": grads, "opt": opt,
                "start": start, "seconds": time.perf_counter() - t0, "step_loss": step_loss,
                "after": {k: p.detach().cpu() for k, p in model.named_parameters()}}

    def parity(cpu, card, ref64):
        """the gaps the step phases hold and record"""
        with torch.no_grad():  # the card's optimizer from the CPU's gradients
            params = card["start"]
            grads = {k: g.to(params[k].device) for k, g in cpu["grads"].items()}
            upd, _ = card["opt"].update(grads, card["opt"].init(params), params)
            cross = {k: (params[k] + upd[k]).cpu() for k in params}
        apart = {k: (card["after"][k] - a).abs() > NNET_STEP_TOL
                 for k, a in cpu["after"].items()}
        gmax = max(float(g.abs().max()) for g in ref64[2].values())
        return {"loss_relative": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                "gradient_l2_relative_card_vs_cpu_float64": l2_gap(card["grads"], ref64[2]),
                "gradient_l2_relative_cpu_float32_vs_float64": l2_gap(cpu["grads"], ref64[2]),
                "gradient_l2_relative_card_vs_cpu": l2_gap(card["grads"], cpu["grads"]),
                "update_from_cpu_gradients_absolute": max(
                    float((cross[k] - a).abs().max()) for k, a in cpu["after"].items()),
                "whole_step_parameters_absolute": max(
                    float((card["after"][k] - a).abs().max())
                    for k, a in cpu["after"].items()),
                "whole_step_elements_apart": sum(int(f.sum()) for f in apart.values()),
                "elements": sum(a.numel() for a in cpu["after"].values()),
                "largest_float64_gradient_of_an_element_apart_relative": max(
                    [float(ref64[2][k][f].abs().max()) / gmax for k, f in apart.items()
                     if f.any()] or [0.0])}

    def held(gaps):
        return (gaps["loss_relative"] <= NNET_STEP_TOL
                and gaps["update_from_cpu_gradients_absolute"] <= NNET_STEP_TOL
                and gaps["gradient_l2_relative_card_vs_cpu_float64"]
                <= gaps["gradient_l2_relative_cpu_float32_vs_float64"])

    def ce_loss_of(where, dtype=torch.float32):
        x, y, m = (torch.as_tensor(a, device=where) for a in (bf, bl, bm))
        return lambda mdl: nnet_train.ce_loss(mdl, x.to(dtype), y, m.to(dtype))

    def ce_model(where, dtype=torch.float32):
        return AmNnet.load("exp/minilib/final.am", device=where).model.to(dtype).train()

    def ce_step(model, opt):
        _, metrics = nnet_train.make_ce_train_step(model, opt)(
            nnet_train.TrainState(opt.init(dict(model.named_parameters())), 0), bf, bl, bm)
        return float(metrics["loss"])

    ce_runs = {w: step_on(ce_model(w), ce_loss_of(w), ce_step, 204) for w in ("cpu", "cuda")}
    ce_ref = probe(ce_model("cpu", torch.float64), ce_loss_of("cpu", torch.float64))
    ce_gaps = parity(ce_runs["cpu"], ce_runs["cuda"], ce_ref)
    emit({"phase": "train_ce_step", "card": card, "model": "exp/minilib/final.am",
          "batch": list(bf.shape), "frames": int(bm.sum()), "loss": ce_runs["cpu"]["loss"],
          "loss_float64": ce_ref[0], **ce_gaps, "tolerance": NNET_STEP_TOL,
          "step_seconds": {w: ce_runs[w]["seconds"] for w in ce_runs}})
    if not held(ce_gaps):
        nnet_faults.append(f"train_ce_step: card vs CPU {ce_gaps}")
    del ce_runs, ce_ref

    ckeys = skeys[:8]
    cms = {w: ChainModel.load("exp/minilib/chain.mdl", device=w) for w in ("cpu", "cuda")}
    sups = [alignment_to_supervision(tri_ali[k], tri.tm, cms["cpu"].ctx_dep, 3,
                                     den=cms["cpu"].den) for k in ckeys]
    csup = pad_supervisions(sups)
    cxent = np.stack([chain_xent_labels(tri_ali[k], tri.tm, cms["cpu"].ctx_dep, 3,
                                        csup[1].shape[1]) for k in ckeys])
    cx = np.zeros((len(ckeys), 3 * csup[1].shape[1], 39), np.float32)
    for i, k in enumerate(ckeys):
        cx[i, : len(sfeats[k])] = sfeats[k][: cx.shape[1]]
    cargs = (cx, *csup, cxent)

    def chain_loss_of(where, dtype=torch.float32):
        t = [torch.as_tensor(a, device=where) for a in cargs]
        t[0], t[5] = t[0].to(dtype), t[5].to(dtype)  # features, advance weights

        def loss_of(mdl):
            logits = mdl(t[0], output_stride=3)[:, : csup[1].shape[1]]
            loss, *values = chain_objective(logits, cms[where].den, ChainLossOptions(), *t[1:])
            return loss, dict(zip(CHAIN_METRICS, values))
        return loss_of

    def chain_step(where):
        def run(model, opt):
            _, loss, _ = make_chain_step(model, cms[where].den, opt, ChainLossOptions(), 3)(
                nnet_train.TrainState(opt.init(dict(model.named_parameters())), 0), *cargs)
            return loss.cpu()
        return run

    def chain_model(where, dtype=torch.float32):
        return copy.deepcopy(cms[where].am.model).to(dtype).train()

    ch_runs = {w: step_on(chain_model(w), chain_loss_of(w), chain_step(w), 75 * CHAIN_EPOCHS)
               for w in ("cpu", "cuda")}
    again = step_on(chain_model("cuda"), chain_loss_of("cuda"), chain_step("cuda"),
                    75 * CHAIN_EPOCHS)
    ch_ref = probe(chain_model("cpu", torch.float64), chain_loss_of("cpu", torch.float64))
    cc, cg = ch_runs["cpu"], ch_runs["cuda"]
    ch_gaps = parity(cc, cg, ch_ref)
    frames = int(csup[2].sum())
    scale = max(abs(cc["metrics"]["num"]), abs(cc["metrics"]["den"])) * len(ckeys) / frames
    ch_gaps.update(
        num_relative=abs(cg["metrics"]["num"] - cc["metrics"]["num"]) / abs(cc["metrics"]["num"]),
        den_relative=abs(cg["metrics"]["den"] - cc["metrics"]["den"]) / abs(cc["metrics"]["den"]),
        objf_relative_to_term_per_frame=abs(cg["metrics"]["objf"] - cc["metrics"]["objf"])
        / scale,
        loss_relative_to_term_per_frame=abs(cg["loss"] - cc["loss"]) / scale)
    repeats = (torch.equal(again["step_loss"], cg["step_loss"])
               and all(torch.equal(again["after"][k], a) for k, a in cg["after"].items()))
    # the objective's cost a step at this batch's shape, forward and
    # backward, by CUDA events over back-to-back calls (the host's launches
    # included: what a step pays): the denominator and the numerator eager,
    # and the whole objective eager and as the captured graphs the chain
    # step replays
    den = cms["cuda"].den
    lg = torch.randn((len(ckeys), csup[1].shape[1], den.num_pdfs), device="cuda",
                     generator=gen)
    tsup = [torch.as_tensor(a, device="cuda") for a in cargs[1:]]

    def fwd_bwd(fn):
        def run():
            x = lg.detach().requires_grad_()
            fn(x).sum().backward()
        return time_ms(torch, run, reps=5, warm=2)

    objective = lambda x, *a: chain_objective(x, den, ChainLossOptions(), *a)  # noqa: E731
    graphed = torch.cuda.make_graphed_callables(objective, (lg.clone().requires_grad_(), *tsup))
    objective_ms = {
        "denominator_eager": fwd_bwd(lambda x: denominator_logprob(x, tsup[2], den, 0.1)),
        "numerator_eager": fwd_bwd(lambda x: numerator_logprob(
            x, tsup[0], tsup[1], tsup[2], tsup[3], tsup[4], float(den.loop_log_prob))),
        "objective_eager": fwd_bwd(lambda x: objective(x, *tsup)[0]),
        "objective_graphed": fwd_bwd(lambda x: graphed(x, *tsup)[0])}
    del lg, graphed
    emit({"phase": "train_chain_step", "card": card, "model": "exp/minilib/chain.mdl",
          "utterances": ckeys, "frames_subsampled": frames,
          "den_states": int(cms["cpu"].den.num_states), "den_arcs": int(len(cms["cpu"].den.pdf)),
          **{k: cc["metrics"][k] for k in ("objf", "num", "den", "xent")},
          "objf_float64": ch_ref[1]["objf"], **ch_gaps, "tolerance": NNET_STEP_TOL,
          "card_step_repeats_bit_for_bit": repeats,
          "objective_shape": [len(ckeys), csup[1].shape[1], den.num_pdfs],
          "objective_forward_backward_ms": objective_ms,
          "step_seconds": {"card": [cg["seconds"], again["seconds"]], "cpu": cc["seconds"]}})
    # the loss and objective are differences of num and den: held against
    # the larger term per frame, not against themselves
    ch_gaps_held = dict(ch_gaps, loss_relative=ch_gaps["loss_relative_to_term_per_frame"])
    if not (held(ch_gaps_held) and max(ch_gaps["num_relative"], ch_gaps["den_relative"],
                                       ch_gaps["objf_relative_to_term_per_frame"])
            <= NNET_STEP_TOL):
        nnet_faults.append(f"train_chain_step: card vs CPU {ch_gaps}")
    # ---- phases 29-33: iVector training (minilib stages 9-11) and the tools
    # beside training (natural-gradient SGD, combination, diagnostics), each
    # path's launch counts set to 0 just before it and read just after; a
    # fault ends the run after these phases.  train_ivector: the training
    # set's features through K2, the UBM and the extractor (final.ie), one EM
    # step of each on both devices, final.ie written and read back, and a
    # full-covariance UBM and its kind-1 extractor; train_ce_ivec (stage 10)
    # and train_chain_ivec (stage 11) on those features with online iVectors
    # from the card's final.ie, then the clean held-out decodes (K1, K2), the
    # chain+iVec model on train_chain's graph once its tree is train_chain's
    from old_kaldi_git_tpu_torch.gmm.full_gmm import train_full_ubm
    from old_kaldi_git_tpu_torch.ivector import extractor as ivx
    from old_kaldi_git_tpu_torch.models import diagnostics
    from old_kaldi_git_tpu_torch.models.egs import get_chain_egs
    from old_kaldi_git_tpu_torch.models.natural_gradient import NgCollector
    from old_kaldi_git_tpu_torch.models.tdnn import make_tdnnf
    from old_kaldi_git_tpu_torch.recipes.chain import combine_chain_models, train_chain
    from old_kaldi_git_tpu_torch.recipes.nnet3 import train_tdnn
    from old_kaldi_git_tpu_torch.tree.context_dep import tree_key

    tool_faults = []

    def rel64(a, b):
        a, b = (torch.as_tensor(v).double().cpu() for v in (a, b))
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))

    zero_counts()
    t0 = time.perf_counter()
    tfeats = minilib.compute_feats(twaves, device=dev)
    torch.cuda.synchronize()
    iv_fe_s = time.perf_counter() - t0
    iv_hist = {}
    t1 = time.perf_counter()
    ext = minilib.train_ivector_system(None, tfeats, topts, device=dev, history=iv_hist)
    torch.cuda.synchronize()
    iv_train_s = time.perf_counter() - t1
    tiv_launches = read_counts("train_ivector")
    ubm_like = [h["avg_loglike"] for h in iv_hist["ubm"]]
    ext_w2 = [h["mean_w2"] for h in iv_hist["extractor"]]
    ubm_gaps = [abs(a - b) for a, b in zip(ubm_like, IVEC_TRAIN_CPU_RECORD["ubm"])]
    w2_gaps = [abs(a - b) / b for a, b in zip(ext_w2, IVEC_TRAIN_CPU_RECORD["extractor"])]
    utts = [tfeats[k] for k in sorted(tfeats)]
    pooled = torch.from_numpy(np.concatenate(utts)[::4].astype(np.float64))
    ubm_step = {w: ivx.ubm_em_step(ext.ubm, pooled.to(w)) for w in ("cpu", "cuda")}
    exts = {w: ivx.IvectorExtractor(ext.ubm, ext.T, w) for w in ("cpu", "cuda")}
    estep = {w: ivx.acc_ivector_extractor_stats(exts[w], utts) for w in exts}
    mstep = {w: ivx.est_ivector_extractor(exts[w], *estep[w][:2]).T for w in exts}
    step_gaps = {
        "ubm": max(rel64(getattr(ubm_step["cuda"], n), getattr(ubm_step["cpu"], n))
                   for n in ("weights", "means", "vars")),
        "extractor_estep": max(rel64(a, b) for a, b in zip(estep["cuda"], estep["cpu"])),
        "extractor_mstep": rel64(mstep["cuda"], mstep["cpu"])}
    del exts, estep, mstep
    with tempfile.TemporaryDirectory() as d:
        ext.save(os.path.join(d, "final.ie"))
        back = ivx.IvectorExtractor.load(os.path.join(d, "final.ie"), device=dev)
    ie_back = {"T_equal": bool(torch.equal(back.T, ext.T)),
               "ubm_relative_to_float32": max(
                   rel64(getattr(back.ubm, n), getattr(ext.ubm, n).astype(np.float32))
                   for n in ("weights", "means", "vars"))}
    t1 = time.perf_counter()
    full_hist, full_w2 = [], []
    fubm = train_full_ubm(ext.ubm, utts, num_iters=4, num_gselect=20, device=dev,
                          history=full_hist)
    fext = ivx.train_ivector_extractor(fubm, utts, ivector_dim=topts.ivector_dim,
                                       num_iters=4, device=dev, history=full_w2)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t1
    hkeys = sorted(system.test_waves)[:16]
    hfeats = minilib.compute_feats({k: system.test_waves[k] for k in hkeys}, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        fext.save(os.path.join(d, "final_full.ie"))
        fback = {w: ivx.IvectorExtractor.load(os.path.join(d, "final_full.ie"), device=w)
                 for w in ("cpu", "cuda")}
    online_gap = max(
        float((ivx.extract_online_ivectors(fback["cuda"], hfeats[k], topts.ivector_period)
               .cpu() - ivx.extract_online_ivectors(fback["cpu"], hfeats[k],
                                                    topts.ivector_period)).abs().max())
        for k in hkeys)
    full_kind = 1 if isinstance(fback["cpu"].ubm, type(fubm)) else 0
    emit({"phase": "train_ivector", "card": card, "utterances": len(utts),
          "ubm_gaussians": ext.ubm.num_mix, "ivector_dim": ext.ivector_dim,
          "pooled_frames": int(pooled.shape[0]), "front_end_seconds": iv_fe_s,
          "train_seconds": iv_train_s, "ubm_avg_loglike_by_iter": ubm_like,
          "ubm_gap_to_cpu_record_nats": ubm_gaps, "mean_w2_by_iter": ext_w2,
          "mean_w2_relative_gap_to_cpu_record": w2_gaps,
          "one_step_card_vs_cpu_relative": step_gaps, "final_ie_read_back": ie_back,
          "full_covariance": {"seconds": full_s, "gselect": 20,
                              "avg_loglike_by_iter": [h["avg_loglike"] for h in full_hist],
                              "mean_w2_by_iter": [h["mean_w2"] for h in full_w2],
                              "kind_read_back": full_kind, "held_out_utterances": len(hkeys),
                              "online_ivectors_card_vs_cpu_absolute": online_gap},
          "mfcc_launches": tiv_launches["mfcc"], "gather_launches": tiv_launches["gather"]})
    if max(ubm_gaps) > IVEC_UBM_TOL or max(w2_gaps) > IVEC_W2_REL:
        tool_faults.append(f"train_ivector: UBM {ubm_gaps} nats or |w|² {w2_gaps} from the "
                           "CPU record")
    if max(step_gaps.values()) > STEP_TOL:
        tool_faults.append(f"train_ivector: one EM step card vs CPU {step_gaps}")
    if not (ie_back["T_equal"] and ie_back["ubm_relative_to_float32"] <= 1e-7):
        tool_faults.append(f"train_ivector: final.ie read back {ie_back}")
    if full_kind != 1 or not online_gap <= IVEC_ONLINE_TOL:
        tool_faults.append(f"train_ivector: kind-1 extractor read back as kind {full_kind}, "
                           f"online iVectors card vs CPU {online_gap}")
    if tiv_launches["mfcc"] == 0:
        tool_faults.append(f"train_ivector did not go through K2: {tiv_launches}")
    del pooled, ubm_step, back, fubm, fext, fback, hfeats

    zero_counts()
    t0 = time.perf_counter()
    ci_hist, ci_tim = [], {}
    am_iv = minilib.train_am_ivec_system(None, tfeats, ext, topts, device=dev,
                                         history=ci_hist, timings=ci_tim)
    torch.cuda.synchronize()
    ci_wall = time.perf_counter() - t0
    ci_launches = {"train": read_counts("train_ce_ivec")}
    zero_counts()
    ci_stages = {}
    ci_wer, _ = minilib.decode_and_score(
        dataclasses.replace(system, ivector_models=(am_iv, ext)), beam=BEAM,
        max_active=IVEC_MAX_ACTIVE, acoustic_scale=1.0, batch=IVEC_BATCH, timings=ci_stages,
        use_ivectors=True)
    ci_launches["decode"] = read_counts("train_ce_ivec_decode")
    ci_stats = minilib.decode_and_score.last_stats
    ci_loss = [h["loss"] for h in ci_hist]
    emit({"phase": "train_ce_ivec", "card": card,
          "model": f"TDNN-F 39 + {ext.ivector_dim} -> 512 (bottleneck 64) x "
                   f"{topts.num_layers} -> {am_iv.config.num_outputs} pdfs of tri.mdl",
          "epochs": len(ci_hist), "steps": ci_tim["steps"], "ce_by_epoch": ci_loss,
          "accuracy_by_epoch": [h["acc"] for h in ci_hist], "wall_seconds": ci_wall,
          "train_seconds": ci_tim["train_seconds"],
          "step_ms": 1e3 * ci_tim["train_seconds"] / ci_tim["steps"],
          "decode": {"graph": "exp/minilib/hclg.npz", "ivectors": "the card's final.ie",
                     "max_active": IVEC_MAX_ACTIVE, "batch": IVEC_BATCH,
                     "wer_percent": ci_wer, "errors": ci_stats["errors"],
                     "ref_words": ci_stats["ref_words"],
                     "utterances_with_errors": ci_stats["utterances_with_errors"],
                     **ci_stages, "gather_launches": ci_launches["decode"]["gather"],
                     "mfcc_launches": ci_launches["decode"]["mfcc"]}})
    if not (len(ci_hist) == CE_EPOCHS and all(np.isfinite(ci_loss))
            and all(b < a for a, b in zip(ci_loss, ci_loss[1:]))):
        tool_faults.append(f"train_ce_ivec: CE by epoch {ci_loss}, not {CE_EPOCHS} finite "
                           "and falling")
    if ci_wer > MAX_WER_PERCENT:
        tool_faults.append(f"train_ce_ivec: WER {ci_wer} % above {MAX_WER_PERCENT} %")
    if not (ci_launches["decode"]["gather"] > 0 and ci_launches["decode"]["mfcc"] > 0):
        tool_faults.append(f"train_ce_ivec did not go through its kernels: {ci_launches}")
    del am_iv

    zero_counts()
    t0 = time.perf_counter()
    cv_hist, cv_rep = [], {}
    cv_model = minilib.train_chain_ivec_system(tfeats, lang, ext, chain_topts, device=dev,
                                               history=cv_hist, report=cv_rep)
    torch.cuda.synchronize()
    cv_wall = time.perf_counter() - t0
    cv_launches = {"train": read_counts("train_chain_ivec")}
    # ---- train_chain's decode (phase 27), on stage 8's graph from the
    # spawned process
    t0 = time.perf_counter()
    ch_csr, ch_graph_rep = ch_graph_future.result()
    ch_graph_wait = time.perf_counter() - t0
    host_pool.shutdown()
    ch_rep.update(ch_graph_rep)
    ch_system = minilib.ChainSystem(minilib.word_table(minilib.make_lexicon(topts)), ch_csr,
                                    ch_model)
    zero_counts()
    ch_stages = {}
    ch_wer, _ = minilib.decode_and_score_chain(
        ch_system, beam=BEAM, max_active=CHAIN_MAX_ACTIVE, batch=CHAIN_BATCH,
        timings=ch_stages)
    ch_launches["decode"] = read_counts("train_chain_decode")
    ch_stats = minilib.decode_and_score_chain.last_stats
    chain_s = sum(ch_rep[k] for k in ("g_seconds", "lg_seconds", "hclg_seconds",
                                      "export_seconds"))
    # K1 at the card-trained chain model's decode shape (its own pdfs and
    # graph), against its plain version
    ntg = build_tile_graph(ch_system.csr)
    Pn = ch_system.model.am.config.num_outputs
    En = _token_budget(ch_system.csr, Kc, ntg.md) * ntg.md
    k1_trained_chain_err = check_gather(
        torch, batched_table_gather, batched_table_gather_plain,
        [(CHAIN_BATCH, Pn, En, 256, 7), (CHAIN_BATCH, Pn, En, 1, 0)], seed=17)
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    k1_trained_chain = gather_at(CHAIN_BATCH, Pn, En, 256)
    del plug
    emit({"phase": "train_chain", "card": card,
          "tree_pdfs": ch_rep["tree_pdfs"], "committed_chain_mdl_pdfs": chain.model.am.config.num_outputs,
          "den_states": ch_rep["den_states"], "den_arcs": ch_rep["den_arcs"],
          "supervision_failures": ch_rep["supervision_failures"],
          "epochs": len(ch_hist), "steps": ch_rep["steps"],
          "objf_by_epoch": ch_objf, "xent_by_epoch": [h["xent"] for h in ch_hist],
          "wall_seconds": ch_wall, "front_end_seconds": ch_fe_s,
          "graph_wait_seconds": ch_graph_wait,
          "objects_seconds": ch_rep["objects_seconds"],
          "supervision_seconds": ch_rep["supervision_seconds"],
          "train_seconds": ch_rep["train_seconds"],
          "step_ms": 1e3 * ch_rep["train_seconds"] / ch_rep["steps"],
          "steps_per_second": ch_rep["steps"] / ch_rep["train_seconds"],
          "peak_device_memory_bytes": ch_peak,
          "mfcc_launches": ch_launches["train"]["mfcc"],
          "graph": {"g_seconds": ch_rep["g_seconds"], "g_states": ch_rep["g_states"],
                    "g_arcs": ch_rep["g_arcs"], "lg_seconds": ch_rep["lg_seconds"],
                    "hclg_seconds": ch_rep["hclg_seconds"],
                    "export_seconds": ch_rep["export_seconds"], "seconds": chain_s,
                    "states": ch_rep["hclg_states"], "emitting_arcs": ch_rep["hclg_arcs"],
                    "backoff_arcs": ch_rep["hclg_backoff_arcs"],
                    "eps_depth": ch_system.csr.eps_depth},
          "gather_kernel_at_decode_shape": {"exact": k1_trained_chain_err == 0.0,
                                            **k1_trained_chain},
          "decode": {"max_active": CHAIN_MAX_ACTIVE, "batch": CHAIN_BATCH,
                     "wer_percent": ch_wer, "errors": ch_stats["errors"],
                     "ref_words": ch_stats["ref_words"],
                     "utterances_with_errors": ch_stats["utterances_with_errors"],
                     **ch_stages, "gather_launches": ch_launches["decode"]["gather"],
                     "mfcc_launches": ch_launches["decode"]["mfcc"]}})
    if ch_wer > MAX_WER_PERCENT:
        tool_faults.append(f"train_chain: WER {ch_wer} % above {MAX_WER_PERCENT} %")
    if k1_trained_chain_err != 0.0:
        tool_faults.append(f"train_chain: K1 differs from its plain version by "
                           f"{k1_trained_chain_err}")
    if not (ch_launches["train"]["mfcc"] > 0 and ch_launches["decode"]["gather"] > 0
            and ch_launches["decode"]["mfcc"] > 0):
        tool_faults.append(f"train_chain did not go through its kernels: {ch_launches}")

    same_tree = tree_key(cv_model.ctx_dep) == tree_key(ch_system.model.ctx_dep)
    cv_wer, cv_stats, cv_stages = None, {}, {}
    if same_tree:
        zero_counts()
        cv_wer, _ = minilib.decode_and_score_chain(
            minilib.on_graph_of(ch_system, cv_model, ext), beam=BEAM,
            max_active=IVEC_MAX_ACTIVE, batch=IVEC_BATCH, timings=cv_stages)
        cv_launches["decode"] = read_counts("train_chain_ivec_decode")
        cv_stats = minilib.decode_and_score_chain.last_stats
    cv_objf = [h["objf"] for h in cv_hist]
    emit({"phase": "train_chain_ivec", "card": card, "tree_pdfs": cv_rep["tree_pdfs"],
          "tree_equals_train_chain": same_tree,
          "train_chain_tree_pdfs": ch_system.model.ctx_dep.num_pdfs,
          "epochs": len(cv_hist), "steps": cv_rep["steps"], "objf_by_epoch": cv_objf,
          "xent_by_epoch": [h["xent"] for h in cv_hist], "wall_seconds": cv_wall,
          "objects_seconds": cv_rep["objects_seconds"],
          "supervision_seconds": cv_rep["supervision_seconds"],
          "train_seconds": cv_rep["train_seconds"],
          "step_ms": 1e3 * cv_rep["train_seconds"] / cv_rep["steps"],
          "decode": {"graph": "train_chain's split-eps HCLG", "ivectors": "the card's final.ie",
                     "max_active": IVEC_MAX_ACTIVE, "batch": IVEC_BATCH, "wer_percent": cv_wer,
                     **{k: v for k, v in cv_stats.items() if k != "wer"}, **cv_stages,
                     **({"gather_launches": cv_launches["decode"]["gather"],
                         "mfcc_launches": cv_launches["decode"]["mfcc"]}
                        if "decode" in cv_launches else {})}})
    if not same_tree:
        tool_faults.append(f"train_chain_ivec: its tree ({cv_rep['tree_pdfs']} pdfs) is not "
                           f"train_chain's ({ch_system.model.ctx_dep.num_pdfs})")
    elif cv_wer > MAX_WER_PERCENT:
        tool_faults.append(f"train_chain_ivec: WER {cv_wer} % above {MAX_WER_PERCENT} %")
    elif not (cv_launches["decode"]["gather"] > 0 and cv_launches["decode"]["mfcc"] > 0):
        tool_faults.append(f"train_chain_ivec did not go through its kernels: {cv_launches}")
    if not (len(cv_hist) == CHAIN_EPOCHS and all(np.isfinite(cv_objf))):
        tool_faults.append(f"train_chain_ivec: objf by epoch {cv_objf}, not {CHAIN_EPOCHS} "
                           "finite")
    del cv_model
    torch.cuda.empty_cache()

    # ---- phase 32, train_ng: one ng-sgd and one ng-sgd-act CE step from
    # final.am and one ng-sgd-act chain step from chain.mdl, each device's
    # loss, gradients (and activation statistics) and update, and the card's
    # optimizer on the CPU's gradients and statistics; then one epoch of
    # ng-sgd CE and one of ng-sgd-act chain on the training set
    def ng_probe(model, loss_of, optimizer):
        model = copy.deepcopy(model)
        opt = nnet_train.make_optimizer(nnet_train.NnetTrainOptions(optimizer=optimizer), 204)
        collector = NgCollector(model) if optimizer == "ng-sgd-act" else None
        params = dict(model.named_parameters())
        if collector is not None:
            collector.active = True
        loss, metrics = loss_of(model)
        loss.backward()
        stats = None
        if collector is not None:
            collector.active = False
            stats = collector.stats()
        grads = {k: p.grad.detach() for k, p in params.items()}
        with torch.no_grad():
            upd, _ = opt.update(grads, opt.init(params), params, stats)
        return {"loss": loss.item(), "metrics": {k: v.item() for k, v in metrics.items()},
                "grads": grads, "stats": stats, "upd": upd, "opt": opt, "params": params}

    def ng_gaps(cpu, cuda):
        on = lambda t: t.to("cuda")  # noqa: E731
        with torch.no_grad():
            stats = None if cpu["stats"] is None else {
                n: {k: on(v) for k, v in d.items()} for n, d in cpu["stats"].items()}
            upd, _ = cuda["opt"].update({k: on(g) for k, g in cpu["grads"].items()},
                                        cuda["opt"].init(cuda["params"]), cuda["params"], stats)
        big = max(float(v.abs().max()) for v in cpu["upd"].values())
        return {"loss_relative": abs(cuda["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                "update_from_cpu_gradients_relative_to_largest": max(
                    float((upd[k].cpu() - v).abs().max()) for k, v in cpu["upd"].items()) / big,
                "card_update_relative_to_largest": max(
                    float((cuda["upd"][k].cpu() - v).abs().max())
                    for k, v in cpu["upd"].items()) / big}

    ng_steps = {}
    for name, model_of, loss_of, opt_name in (
            ("ce_ng_sgd", ce_model, ce_loss_of, "ng-sgd"),
            ("ce_ng_sgd_act", ce_model, ce_loss_of, "ng-sgd-act"),
            ("chain_ng_sgd_act", chain_model, chain_loss_of, "ng-sgd-act")):
        runs = {w: ng_probe(model_of(w), loss_of(w), opt_name) for w in ("cpu", "cuda")}
        gaps = ng_gaps(runs["cpu"], runs["cuda"])
        if name.startswith("chain"):
            m = runs["cpu"]["metrics"]
            frames = int(csup[2].sum())
            gaps["loss_relative_to_term_per_frame"] = abs(
                runs["cuda"]["loss"] - runs["cpu"]["loss"]) / (
                max(abs(m["num"]), abs(m["den"])) * len(ckeys) / frames)
        ng_steps[name] = {"loss": runs["cpu"]["loss"], **gaps}
        held_loss = gaps.get("loss_relative_to_term_per_frame", gaps["loss_relative"])
        if not (held_loss <= NNET_STEP_TOL and gaps[
                "update_from_cpu_gradients_relative_to_largest"] <= NNET_STEP_TOL):
            tool_faults.append(f"train_ng: {name} card vs CPU {gaps}")
        del runs
    zero_counts()
    t0 = time.perf_counter()
    ng_ce_hist, ng_ce_tim = [], {}
    ng_am = train_tdnn(tri, tfeats, tri_ali, opts=nnet_train.NnetTrainOptions(
        num_epochs=1, optimizer="ng-sgd"), config=make_tdnnf(
        39, tri.am.num_pdfs, topts.hidden_dim, topts.bottleneck_dim, topts.num_layers),
        device=dev, history=ng_ce_hist, timings=ng_ce_tim)
    torch.cuda.synchronize()
    ng_ce_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ng_ch_hist, ng_ch_rep = [], {}
    ng_cm = train_chain(tri, tfeats, tri_ali, lang, dataclasses.replace(
        minilib.chain_train_options(topts), num_epochs=1, optimizer="ng-sgd-act"),
        device=dev, history=ng_ch_hist, report=ng_ch_rep)
    torch.cuda.synchronize()
    ng_ch_s = time.perf_counter() - t0
    ng_launches = read_counts("train_ng")
    ce_steps = ng_ce_hist[0]["step_losses"] if ng_ce_hist else []
    ch_steps = ng_ch_hist[0]["step_objf"] if ng_ch_hist else []
    ce_falls = bool(ce_steps) and np.mean(ce_steps[-10:]) < np.mean(ce_steps[:10])
    ch_rises = (bool(ch_steps) and bool(np.all(np.isfinite(ch_steps)))
                and np.mean(ch_steps[-10:]) > np.mean(ch_steps[:10]))
    emit({"phase": "train_ng", "card": card, "one_step_card_vs_cpu": ng_steps,
          "ce_ng_sgd_epoch": {"steps": len(ce_steps), "seconds": ng_ce_s,
                              "step_ms": 1e3 * ng_ce_tim["train_seconds"] / max(len(ce_steps), 1),
                              "ce_first_10_steps": float(np.mean(ce_steps[:10])),
                              "ce_last_10_steps": float(np.mean(ce_steps[-10:])),
                              "ce_mean": ng_ce_hist[0]["loss"] if ng_ce_hist else None},
          "chain_ng_sgd_act_epoch": {
              "steps": len(ch_steps), "seconds": ng_ch_s,
              "step_ms": 1e3 * ng_ch_rep["train_seconds"] / max(len(ch_steps), 1),
              "tree_pdfs": ng_ch_rep["tree_pdfs"],
              "objf_first_10_steps": float(np.mean(ch_steps[:10])),
              "objf_last_10_steps": float(np.mean(ch_steps[-10:])),
              "objf_mean": ng_ch_hist[0]["objf"] if ng_ch_hist else None},
          "mfcc_launches": ng_launches["mfcc"], "gather_launches": ng_launches["gather"]})
    if not ce_falls:
        tool_faults.append("train_ng: the ng-sgd CE epoch's CE did not fall")
    if not ch_rises:
        tool_faults.append("train_ng: the ng-sgd-act chain epoch's objf did not rise finite")
    del ng_am

    # ---- phase 33, combine: combine_models([train_ce's model, final.am]) on
    # 64 training utterances labelled from tri_ali.pkl, combine_chain_models(
    # [train_chain's model, the ng-sgd-act chain model]) on the 32 shortest
    # utterances' chain egs (one tree), and compute_prob / compute_chain_prob
    # of the card-trained models, each card vs CPU
    zero_counts()
    t0 = time.perf_counter()
    ckeys64 = sorted(tfeats)[:64]
    cb_feats = {k: tfeats[k] for k in ckeys64}
    cb_labels = {k: np.asarray(alignment_to_pdfs(tri.tm, tri_ali[k]), np.int32)
                 for k in ckeys64}
    final_am = AmNnet.load("exp/minilib/final.am", device=dev)
    ce_rep = {}
    nnet_train.combine_models([ce_am, final_am], cb_feats, cb_labels, report=ce_rep)
    torch.cuda.synchronize()
    ce_comb_s = time.perf_counter() - t0

    def on_cpu(am):
        priors = None if am.log_priors is None else am.log_priors.cpu().numpy()
        return AmNnet(am.config, copy.deepcopy(am.model), priors, device="cpu",
                      ivector_dim=am.ivector_dim)

    ce_short = {}
    for w, ams in (("cuda", [ce_am, final_am]), ("cpu", [on_cpu(ce_am), on_cpu(final_am)])):
        ce_short[w] = {}
        nnet_train.combine_models(ams, cb_feats, cb_labels, num_steps=COMBINE_CPU_STEPS,
                                  report=ce_short[w])
    prob = {w: diagnostics.compute_prob(am, cb_feats, cb_labels)
            for w, am in (("cuda", ce_am), ("cpu", on_cpu(ce_am)))}
    t0 = time.perf_counter()
    eg_keys = sorted(tfeats, key=lambda k: (len(tfeats[k]), k))[:32]
    base = ch_system.model
    same_chain_tree = tree_key(ng_cm.ctx_dep) == tree_key(base.ctx_dep)
    egs = [e for k in eg_keys for e in get_chain_egs(tfeats[k], tri_ali[k], tri.tm,
                                                      base.ctx_dep, base.den)]
    ch_rep_c = {}
    combine_chain_models([base, ng_cm], egs, report=ch_rep_c)
    torch.cuda.synchronize()
    ch_comb_s = time.perf_counter() - t0

    def chain_on_cpu(cm):
        return ChainModel.from_parts(on_cpu(cm.am), cm.ctx_dep, cm.tm, cm.den,
                                     cm.frame_subsampling_factor)

    ch_short = {}
    for w, cms_ in (("cuda", [base, ng_cm]), ("cpu", [chain_on_cpu(base),
                                                      chain_on_cpu(ng_cm)])):
        ch_short[w] = {}
        combine_chain_models(cms_, egs, num_steps=COMBINE_CPU_STEPS, report=ch_short[w])
    eg_feats = {k: tfeats[k] for k in eg_keys}
    cprob = {w: diagnostics.compute_chain_prob(cm, eg_feats, tri_ali, tri)
             for w, cm in (("cuda", base), ("cpu", chain_on_cpu(base)))}
    cb_launches = read_counts("combine")
    wgap = {n: float(np.abs(np.asarray(r["cuda"]["weights"])
                            - np.asarray(r["cpu"]["weights"])).max())
            for n, r in (("ce", ce_short), ("chain", ch_short))}
    prob_gap = {"compute_prob_ce": abs(prob["cuda"][0] - prob["cpu"][0]) / abs(prob["cpu"][0]),
                "compute_chain_prob": abs(cprob["cuda"] - cprob["cpu"]) / abs(cprob["cpu"])}
    emit({"phase": "combine", "card": card,
          "ce": {"models": ["train_ce", "exp/minilib/final.am"], "utterances": len(ckeys64),
                 "steps": len(ce_rep["objf_by_step"]), "weights": ce_rep["weights"],
                 "objf_uniform": ce_rep["objf_uniform"], "objf_final": ce_rep["objf_final"],
                 "seconds": ce_comb_s},
          "chain": {"models": ["train_chain", "train_ng's ng-sgd-act chain model"],
                    "egs": len(egs), "same_tree": same_chain_tree,
                    "steps": len(ch_rep_c["objf_by_step"]), "weights": ch_rep_c["weights"],
                    "objf_uniform": ch_rep_c["objf_uniform"],
                    "objf_final": ch_rep_c["objf_final"], "seconds": ch_comb_s},
          "card_vs_cpu": {"steps": COMBINE_CPU_STEPS, "weights_absolute": wgap,
                          "weights": {"ce": ce_short, "chain": ch_short}},
          "compute_prob": {"card": prob["cuda"], "cpu": prob["cpu"]},
          "compute_chain_prob": {"card": cprob["cuda"], "cpu": cprob["cpu"]},
          "diagnostics_card_vs_cpu_relative": prob_gap,
          "mfcc_launches": cb_launches["mfcc"], "gather_launches": cb_launches["gather"]})
    if not (ce_rep["objf_final"] <= ce_rep["objf_uniform"]
            and ch_rep_c["objf_final"] <= ch_rep_c["objf_uniform"]):
        tool_faults.append(f"combine: worse than uniform weights: CE {ce_rep['objf_uniform']} "
                           f"-> {ce_rep['objf_final']}, chain {ch_rep_c['objf_uniform']} -> "
                           f"{ch_rep_c['objf_final']}")
    if not same_chain_tree:
        tool_faults.append("combine: the two chain models' trees differ")
    if max(wgap.values()) > COMBINE_WEIGHT_TOL:
        tool_faults.append(f"combine: weights card vs CPU {wgap}")
    if max(prob_gap.values()) > NNET_STEP_TOL:
        tool_faults.append(f"combine: diagnostics card vs CPU {prob_gap}")
    del tfeats, ext, ng_cm, final_am, egs, ce_am, ch_system
    torch.cuda.empty_cache()
    del ch_runs, again, ch_ref, cc, cg, cms, sfeats
    torch.cuda.empty_cache()
    if nnet_faults:
        raise RuntimeError("neural training: " + "; ".join(nnet_faults))
    if tool_faults:
        raise RuntimeError("iVector training and training tools: " + "; ".join(tool_faults))

    # ---- phases 25-27: the fused toy pipeline (bench.py's run_toy), its
    # lattice mode and the dense StreamingDecoder on the toy graph
    t0 = time.perf_counter()
    toy_system = toy.build_toy_system(device=dev)
    toy_build_s = time.perf_counter() - t0
    tgen = torch.Generator(device="cuda").manual_seed(1)
    toy_waves = 2000.0 * torch.randn((TOY_BATCH, int(TOY_SECONDS * 16000)), device=dev,
                                     generator=tgen)
    toy.decode_toy(toy_system, toy_waves[:2])  # warm-up: cuBLAS handles, kernels loaded
    zero_counts()
    t0 = time.perf_counter()
    ystages = {}
    yres = toy.decode_toy(toy_system, toy_waves, timings=ystages)
    torch.cuda.synchronize()
    ywall = time.perf_counter() - t0
    y_launches = read_counts("decode_toy")
    y_peak = torch.cuda.max_memory_allocated()
    # K2 at the toy's shape: every frame of the 1,024 waves at W = 512
    yframes, _ = extract_frames(toy_waves, opts16.frame_opts)
    yframes = yframes.reshape(-1, yframes.shape[-1])
    del toy_waves
    y_err, y_err64, _ = check_mfcc(torch, fused_mfcc_from_frames, fused_mfcc_reference,
                                   [(yframes, w16, w16d, True)])
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    yn = yframes.shape[0]
    y_bytes_ms = 1e3 * 4 * yn * (512 + w16[3].shape[1]) / H100_HBM_BYTES_PER_S
    y_ops_ms = 1e3 * mfcc_flops(yn, 512, int(mel_spans(w16[2].cpu().numpy())[:, 1].sum()),
                                w16[2].shape[1], w16[3].shape[1]) / H100_FP64_FLOPS
    k2_toy = {"shape": [yn, 512], "max_abs_err": y_err,
              "max_abs_err_vs_float64_plain": y_err64,
              "kernel_ms": time_ms(torch, lambda: fused_mfcc_from_frames(yframes, w16),
                                   reps=5, plug=plug),
              "plain_ms": time_ms(torch, lambda: fused_mfcc_reference(yframes, w16),
                                  reps=2, warm=1, plug=plug),
              "library_ms": None,
              "rfft_only_ms": time_ms(torch, lambda: torch.fft.rfft(yframes, dim=1),
                                      reps=5, plug=plug),
              "rfft_only": "torch.fft.rfft of the same frames in fp32: the spectrum "
                           "alone, not the function",
              "bytes": 4 * yn * (512 + w16[3].shape[1]),
              "bound_ms": max(y_bytes_ms, y_ops_ms),
              "bound_by": "operations" if y_ops_ms >= y_bytes_ms else "bytes"}
    del yframes, plug
    torch.cuda.empty_cache()
    emit({"phase": "decode_toy", "card": card, "batch": TOY_BATCH,
          "seconds_each": TOY_SECONDS, "graph_states": toy_system.csr.num_states,
          "graph_arcs": toy_system.csr.num_arcs, "K": toy_system.csr.num_states,
          "beam": toy.BEAM, "decoded": sum(r is not None for r in yres),
          "wall_seconds": ywall, **ystages,
          "audio_seconds_per_second": TOY_BATCH * TOY_SECONDS / ywall,
          "build_seconds": toy_build_s, "mfcc_at_this_shape": k2_toy,
          "peak_device_memory_bytes": y_peak,
          "gather_launches": y_launches["gather"], "mfcc_launches": y_launches["mfcc"],
          "mfcc_launches_by_route": y_launches["mfcc_by_route"]})
    if y_launches["mfcc"] == 0:
        raise RuntimeError(f"the toy pipeline did not go through the MFCC kernel: {y_launches}")
    del yres

    lrng = np.random.default_rng(5)
    vocab = sorted(w for w in toy_system.lang.words.symbols() if w.startswith("w"))
    lsents = [[vocab[i] for i in lrng.integers(0, len(vocab), lrng.integers(2, 7))]
              for _ in range(TOY_LATTICE_UTTS)]
    lll, lnf = toy.synthetic_loglikes(toy_system, lsents, seed=6)
    lopts = ViterbiOptions(beam=toy.BEAM, max_active=TOY_LATTICE_MAX_ACTIVE,
                           acoustic_scale=1.0)
    zero_counts()
    t0 = time.perf_counter()
    card_res = decode_batch(toy_system.csr, lll, lnf, lopts, want_lattice=True, device=dev)
    torch.cuda.synchronize()
    lwall = time.perf_counter() - t0
    tl_launches = read_counts("toy_lattice")
    cpu_res = decode_batch(toy_system.csr, lll, lnf, lopts, want_lattice=True, device="cpu")
    t0 = time.perf_counter()
    ldiff, lbest, lright, larcs = [], [], 0, 0
    for i, (r, c) in enumerate(zip(card_res, cpu_res)):
        if (r is None) != (c is None) or (r is not None and r.words != c.words):
            ldiff.append(i)
        lat = None if r is None else lattice_from_decode(
            toy_system.csr, lll[i, : lnf[i]], r.frame_states, r.frame_costs, 1.0,
            lattice_beam=8.0)
        larcs += 0 if lat is None else lat.num_arcs
        if lat is None or (lattice_best_path(lat, 1.0, 1.0)[0]
                           + end_state_words(np, toy_system.csr, r)) != r.words:
            lbest.append(i)
        lright += r is not None and [toy_system.lang.words[w] for w in r.words] == lsents[i]
    emit({"phase": "toy_lattice", "card": card, "utterances": len(lsents),
          "frames": int(lnf.sum()), "max_active": TOY_LATTICE_MAX_ACTIVE,
          "K": min(TOY_LATTICE_MAX_ACTIVE, toy_system.csr.num_states),
          "decode_seconds": lwall, "lattice_build_seconds": time.perf_counter() - t0,
          "lattice_arcs": larcs, "utterances_with_the_sentence": int(lright),
          "words_differing_from_cpu": ldiff, "best_path_differing_from_decoder": lbest,
          "gather_launches": tl_launches["gather"]})
    if ldiff or lbest:
        raise RuntimeError(f"toy lattices: card words differ from the CPU's on {ldiff}, "
                           f"best paths differ from the decoder's on {lbest}")

    sopts = ViterbiOptions(beam=toy.BEAM, max_active=toy_system.csr.num_states,
                           acoustic_scale=1.0)
    want = decode_batch(toy_system.csr, lll, lnf, sopts, device=dev)
    sdense = StreamingDecoder(toy_system.csr, lambda x: x, [toy_system.lang.silence_id],
                              toy_system.tm.tid_to_phone_array(), sopts,
                              chunk_quantum=STREAM_CHUNK, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    sd_differ, sd_frames = [], 0
    for i in range(len(lsents)):
        sdense.reset()
        x = lll[i, : lnf[i]]
        for lo in range(0, len(x), STREAM_CHUNK):
            sdense.advance(x[lo: lo + STREAM_CHUNK], final=lo + STREAM_CHUNK >= len(x))
        sd_frames += len(x)
        if sdense.best_words() != (want[i].words if want[i] is not None else []):
            sd_differ.append(i)
    torch.cuda.synchronize()
    sd_wall = time.perf_counter() - t0
    sd_launches = read_counts("stream_dense")
    emit({"phase": "stream_dense", "card": card, "utterances": len(lsents),
          "frames": sd_frames, "chunk_frames": STREAM_CHUNK, "K": sdense.K,
          "wall_seconds": sd_wall, "ms_per_frame": 1e3 * sd_wall / sd_frames,
          "utterances_differing_from_batch": sd_differ,
          "gather_launches": sd_launches["gather"]})
    if sd_differ:
        raise RuntimeError(f"stream_dense: utterances {sd_differ} differ from the batch decode")
    del sdense, toy_system
    torch.cuda.empty_cache()

    # ---- phases 28-31: BASELINE config 2 and run_all -------------------------
    # run_all: the port's recipes/run_all.py (the five configs on yesno, 24
    # training and 8 test utterances) in a fresh workdir, stages 0-80, the
    # WER lines gated as tests/test_run_all.py gates them; a second run must
    # skip every stage and leave RESULTS as it was
    from old_kaldi_git_tpu_torch.recipes import run_all
    from old_kaldi_git_tpu_torch.recipes.gmm_common import align_all
    from old_kaldi_git_tpu_torch.transform.fmllr import apply_affine_transform
    from old_kaldi_git_tpu_torch.utils.table import read_table

    ra_dir = tempfile.mkdtemp(prefix="run_all_")
    zero_counts()
    gmm_loglikes.launches = 0
    t0 = time.perf_counter()
    ra_ctx = run_all.run_all(ra_dir, device=dev)
    torch.cuda.synchronize()
    ra_wall = time.perf_counter() - t0
    ra_launches = read_counts("run_all")
    ra_launches["gmm"] = gmm_loglikes.launches
    with open(os.path.join(ra_dir, "RESULTS")) as f:
        ra_results = f.read()
    ra_wers, ra_rtf = {}, None
    for ln in ra_results.splitlines():
        if ln.startswith("%WER"):
            ra_wers[ln.split("[")[1].rstrip("]")] = float(ln.split()[1])
        elif ln.startswith("RTF"):
            ra_rtf = float(ln.split()[1])
    t0 = time.perf_counter()
    again = run_all.run_all(ra_dir, device=dev)
    ra_resume_s = time.perf_counter() - t0
    with open(os.path.join(ra_dir, "RESULTS")) as f:
        ra_same = f.read() == ra_results
    emit({"phase": "run_all", "card": card, "workdir": "a fresh temporary directory",
          "wall_seconds": ra_wall,
          "stage_seconds": {str(k): v for k, v in sorted(ra_ctx.stage_seconds.items())},
          "wer_percent": ra_wers, "rtf_streaming": ra_rtf,
          "resume_seconds": ra_resume_s, "resume_stages_run": sorted(again.stage_seconds),
          "resume_results_unchanged": ra_same,
          "gather_launches": ra_launches["gather"], "mfcc_launches": ra_launches["mfcc"],
          "gmm_launches": ra_launches["gmm"]})
    for name in RUN_ALL_GATED:
        gate = 5.0 if name.startswith("nnet3-tdnn") else 2.0
        if not ra_wers.get(name, 1e9) <= gate:
            cfg2_faults.append(f"run_all: {name} WER {ra_wers.get(name)} above {gate}")
    if ra_rtf is None or not ra_rtf > 0:
        cfg2_faults.append("run_all: no RTF line")
    if again.stage_seconds or not ra_same:
        cfg2_faults.append(f"run_all: the resumed run ran {sorted(again.stage_seconds)} "
                           f"(RESULTS unchanged: {ra_same})")
    if min(ra_launches["gather"], ra_launches["mfcc"], ra_launches["gmm"]) == 0:
        cfg2_faults.append(f"run_all did not go through its kernels: {ra_launches}")

    # train_sat: the SAT recipe at yesno scale from run_all's tri2b (its
    # features, model and alignments), three speakers, so that the batched
    # per-speaker fMLLR solve runs on the card
    _, ra_text, _, _ = yesno.make_corpus(run_all.NUM_TRAIN, run_all.NUM_TEST)
    ra_transform = np.load(os.path.join(ra_dir, "tri2b/transform.npy"))
    ra_static = read_table(f"ark:{os.path.join(ra_dir, 'data/static_train.ark')}", "mat")
    sat_feats = {k: (triphone.splice_numpy(v) @ ra_transform.T).astype(np.float32)
                 for k, v in ra_static.items()}
    sat_spk = {k: f"spk{int(k.split('_')[1]) % 3}" for k in sat_feats}
    tri2b = AmGmmModel.load(os.path.join(ra_dir, "tri2b/final.mdl"), device=dev)
    tri2b_ali = read_table(f"ark:{os.path.join(ra_dir, 'tri2b/ali.ark')}", "ivec")
    zero_counts()
    gmm_loglikes.launches = 0
    sat_tim = {}
    t0 = time.perf_counter()
    sat_model, _, sat_w, sat_ali = triphone.train_sat(
        sat_feats, ra_text, yesno.make_lang(), tri2b, tri2b_ali, sat_spk, num_leaves=60,
        fmllr_iters=(2, 4), opts=GmmTrainOptions(num_iters=8, totgauss=60,
                                                  realign_iters=(1, 2, 3, 4, 6)),
        device=dev, timings=sat_tim)
    torch.cuda.synchronize()
    sat_wall = time.perf_counter() - t0
    sat_launches = read_counts("train_sat")
    sat_launches["gmm"] = gmm_loglikes.launches
    emit({"phase": "train_sat", "card": card, "utterances": len(sat_feats),
          "speakers": sorted(sat_w), "wall_seconds": sat_wall,
          "fmllr_seconds": sat_tim.get("fmllr_seconds"),
          "gaussians_final": sat_model.am.num_gauss, "aligned": len(sat_ali),
          "transform_max_abs": {s: float(np.abs(w).max()) for s, w in sat_w.items()},
          "gather_launches": sat_launches["gather"], "gmm_launches": sat_launches["gmm"]})
    if (sorted(sat_w) != ["spk0", "spk1", "spk2"] or len(sat_ali) != len(sat_feats)
            or not all(np.isfinite(w).all() for w in sat_w.values())):
        cfg2_faults.append(f"train_sat: transforms for {sorted(sat_w)}, "
                           f"{len(sat_ali)} alignments")


    # ---- phases 32-35: sequence training (flat-start and semi-supervised
    # LF-MMI, MMI of GMMs by EBW, nnet3 MMI / sMBR), each path's counts set to
    # 0 just before it and read just after
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    seq = sequence_training(torch, np, argparse.Namespace(
        dev=dev, card=card, emit=emit, minilib=minilib, convert=convert, chain=chain,
        system=system, twaves=twaves, ttext=ttext, lang=lang, topts=topts, gen=gen,
        plug=plug, zero_counts=zero_counts, read_counts=read_counts,
        gmm_loglikes=gmm_loglikes, gmm_loglikes_plain=gmm_loglikes_plain,
        gather_at=gather_at,
        token_budget=lambda k: _token_budget(system.csr, max(4, min(k, system.csr.num_states)),
                                             tg.md) * tg.md))
    del plug
    torch.cuda.empty_cache()
    seq_launches = seq["launches"]

    # ---- lda_mllt_minilib's decode and gmm_kernel_depths (BASELINE config
    # 2, continued): after sequence training, so that the HCLG of the new
    # tree (264-350 s of host work in its spawned process) is built behind
    # run_all, train_sat and sequence training instead of being waited for
    # the decode: the first 64 clean held-out utterances through K2, spliced
    # and projected, an HCLG of the new tree and the pruned trigram
    t0 = time.perf_counter()
    lm_csr, lm_graph_tim = lm_graph.result()
    graph_pool.shutdown()
    lm_stages["graph_wait_seconds"] = time.perf_counter() - t0
    lm_stages.update(lm_graph_tim)
    dkeys = sorted(system.test_waves)[:LDA_MLLT_DECODE_UTTS]
    dtext = {k: system.test_text[k] for k in dkeys}
    zero_counts()
    gmm_loglikes.launches = 0
    t0 = time.perf_counter()
    dstatics = compute_utterance_feats({k: system.test_waves[k] for k in dkeys},
                                       minilib.SAMP_FREQ, dev, deltas=False, chunk=FEAT_CHUNK)
    dfeats = {k: (triphone.splice_numpy(v) @ lm_res.transform.T).astype(np.float32)
              for k, v in dstatics.items()}
    torch.cuda.synchronize()
    lm_stages["decode_features_seconds"] = time.perf_counter() - t0
    lm_passes = {}
    t0 = time.perf_counter()
    hyps1 = decode.decode_dataset(lm_res.model, lm_csr, system.words, dfeats,
                                  decode.DecodeOptions())
    torch.cuda.synchronize()
    lm_stages["decode_seconds"] = time.perf_counter() - t0
    lm_passes["lda_mllt"] = decode.score_hyps(dtext, hyps1)
    t0 = time.perf_counter()
    hyp_keys = sorted(k for k, v in hyps1.items() if v)
    _, fp, fnf = pad_feature_batch({k: dfeats[k] for k in hyp_keys})
    fgraphs = GraphCompiler(lm_lang, lm_res.ctx_dep, lm_res.model.tm).compile_csr_graphs(
        [hyps1[k] for k in hyp_keys])
    falis, _ = align_all(lm_res.model.am, fgraphs, torch.from_numpy(fp).to(dev), fnf,
                         ViterbiOptions(beam=32.0))
    fw = triphone.estimate_fmllr_per_speaker(
        lm_res.model, dfeats, {k: a for k, a in zip(hyp_keys, falis) if a is not None},
        {k: k for k in dfeats}, min_count=50.0)
    adapted = {k: apply_affine_transform(v, fw[k]) if k in fw else v
               for k, v in dfeats.items()}
    torch.cuda.synchronize()
    lm_stages["fmllr_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyps2 = decode.decode_dataset(lm_res.model, lm_csr, system.words, adapted,
                                  decode.DecodeOptions())
    torch.cuda.synchronize()
    lm_stages["decode_fmllr_seconds"] = time.perf_counter() - t0
    lm_passes["lda_mllt+fmllr"] = decode.score_hyps(dtext, hyps2)
    lm_dec_launches = read_counts("lda_mllt_minilib_decode")
    lm_dec_launches["gmm"] = gmm_loglikes.launches
    emit({"phase": "lda_mllt_minilib", "card": card, "utterances": len(lm_statics),
          "frames": lm_hist[0]["frames"], "leaves": lm_res.ctx_dep.num_pdfs,
          "dim": int(lm_res.transform.shape[0]), **LDA_MLLT_OPTS,
          "num_iters": lm_opts.num_iters, "totgauss": lm_opts.totgauss,
          "gaussians": [h["gaussians"] for h in lm_hist],
          "gaussians_final": lm_res.model.am.num_gauss,
          "like_per_frame": [h["like_per_frame"] for h in lm_hist],
          "against_cpu_record": lm_verdict, "rerun_from_cpu_statics": lm_rerun,
          "like_tolerance": LDA_MLLT_LIKE_TOL, "transform_tolerance": LDA_MLLT_TRANSFORM_REL,
          "stage_seconds": {**lm_stages, **{k: v for k, v in lm_tim.items()
                                            if k.endswith("seconds")}},
          "align_passes": lm_tim.get("align_passes"),
          "decode_utterances": len(dkeys), "fmllr_utterances": len(fw),
          "hclg_states": lm_csr.num_states, "hclg_arcs": lm_csr.num_arcs,
          "wer_percent": {n: s.wer for n, s in lm_passes.items()},
          "errors": {n: s.errors for n, s in lm_passes.items()},
          "ref_words": lm_passes["lda_mllt"].ref_len,
          "train_launches": {k: lm_launches[k] for k in ("gather", "mfcc", "gmm")},
          "decode_launches": {k: lm_dec_launches[k] for k in ("gather", "mfcc", "gmm")}})
    for n, s in lm_passes.items():
        if not (s.ref_len > 0 and s.wer <= LDA_MLLT_MAX_WER):
            cfg2_faults.append(f"lda_mllt_minilib: {n} {s.report()}")
    if min(lm_launches["gmm"], lm_launches["gather"], lm_launches["mfcc"],
           lm_dec_launches["gmm"], lm_dec_launches["gather"]) == 0:
        cfg2_faults.append(f"lda_mllt_minilib did not go through its kernels: "
                           f"{lm_launches}, {lm_dec_launches}")

    # gmm_kernel_depths: K3 at its two new depths, against its plain version
    # on the models and features these recipes produce: run_all's tri2b on
    # the yesno test set's LDA+MLLT features (D = 20, K = 48) and the minilib
    # tri2b on the 600 training utterances' (D = 40, K = 88), each whole and
    # at 1, 45 and 129 rows; timed with its bound and the product alone
    ra_test = read_table(f"ark:{os.path.join(ra_dir, 'data/static_test.ark')}", "mat")
    y20 = torch.from_numpy(np.concatenate(
        [(triphone.splice_numpy(ra_test[k]) @ ra_transform.T).astype(np.float32)
         for k in sorted(ra_test)])).to(dev)
    m40 = torch.from_numpy(np.concatenate(
        [(triphone.splice_numpy(lm_statics[k]) @ lm_res.transform.T).astype(np.float32)
         for k in sorted(lm_statics)])).to(dev)
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    depth_ptxas = ptxas_by_depth(_build.build_logs().get("gmm", ""))
    k3_depths = {}
    for name, gmodel, x in (("yesno_tri2b_D20", tri2b, y20), ("minilib_tri2b_D40",
                                                            lm_res.model, m40)):
        gwd = gmodel.am.weights()
        edge_err, edge_share = check_gmm(torch, gmm_loglikes, gmm_loglikes_plain,
                                         [(x[:n].contiguous(), gwd) for n in (1, 45, 129)])
        line = k3_at(torch, gmm_loglikes, gmm_loglikes_plain, gwd, x, plug)
        line["depth"] = gwd.depth
        line["max_abs_err"] = max(line["max_abs_err"], edge_err)
        line["worst_share_of_tolerance"] = max(line["worst_share_of_tolerance"], edge_share)
        line["ptxas"] = depth_ptxas.get(f"K={gwd.depth}")
        k3_depths[name] = line
    emit({"phase": "gmm_kernel_depths", "card": card,
          "tolerance": f"{GMM_TOL[0]} + {GMM_TOL[1]}*|plain|",
          "bound_basis": "3xTF32 products at 495 TFLOP/s, or bytes at 3.35 TB/s",
          **k3_depths})
    if sorted(v["depth"] for v in k3_depths.values()) != [48, 88]:
        cfg2_faults.append(f"gmm_kernel_depths: depths {[v['depth'] for v in k3_depths.values()]}")
    del plug, y20, m40, lm_res, lm_csr, lm_statics, lm_tri, tri2b, sat_model
    torch.cuda.empty_cache()
    shutil.rmtree(ra_dir, ignore_errors=True)
    cfg2_launches = {"run_all": ra_launches, "train_sat": sat_launches,
                     "lda_mllt_minilib": lm_launches,
                     "lda_mllt_minilib_decode": lm_dec_launches}
    if cfg2_faults:
        raise RuntimeError("BASELINE config 2 and run_all: " + "; ".join(cfg2_faults))

    # ---- phase 36: lattice outputs (n-best, MBR, CTM, posteriors, archives,
    # native determinization, big-LM and LM-weight-sweep scoring, the RNNLM),
    # the counts set to 0 just before it and read just after
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    lo = lattice_outputs(torch, np, argparse.Namespace(
        dev=dev, card=card, emit=emit, minilib=minilib, system=system, lang=lang,
        zero_counts=zero_counts, read_counts=read_counts, gmm_loglikes=gmm_loglikes,
        gmm_loglikes_plain=gmm_loglikes_plain, gather_at=gather_at, k3_at=k3_at, plug=plug,
        compute_wer=compute_wer, pad_feature_batch=pad_feature_batch,
        rescore_lms=rescore_lms,
        token_budget=lambda k: _token_budget(system.csr, max(4, min(k, system.csr.num_states)),
                                             tg.md) * tg.md))
    del plug, rescore_lms
    torch.cuda.empty_cache()
    if lo["faults"]:
        raise RuntimeError("lattice_outputs: " + "; ".join(lo["faults"]))
    lo_launches = lo["launches"]

    # ---- phases 37-39: the remaining nnet3 architectures (TDNN-LSTM,
    # TDNN-attention, CNN-TDNN-F on Fbank) trained, decoded and streamed,
    # xconfig models and the Fbank / PLP front ends card vs CPU; then nnet12
    # (nnet1 and nnet2 on the architectures' features, yesno); each path's
    # counts set to 0 just before it and read just after
    arch_launches = run_architectures(topts, twaves)

    # ---- phases 40-42: the command-line tools (cli, cli_lattice, cli_train,
    # cli_nnet3), SGMM2 (the library's training on align_tri's graphs, its
    # decode, its tools) and the speaker-ID tools, the counts set to 0 just
    # before each path and read just after
    cli_res, lat_res, trn_res, nn3_res, sg_res, sp_res = run_cli(
        twaves, ttext, graphs=a_results["align_tri"].graphs, lang=lang)
    cli_launches, lat_launches, trn_launches, nn3_launches = (
        cli_res["launches"], lat_res["launches"], trn_res["launches"], nn3_res["launches"])
    sg_launches, sp_launches = sg_res["by_path"], sp_res["launches"]
    del a_results

    # ---- phase 43: the keyword-search tools on lattice_outputs' lattices
    kws_res = cli_kws(torch, np, argparse.Namespace(
        dev=dev, card=card, emit=emit, minilib=minilib, system=system,
        lattices=lo.pop("lattices"), zero_counts=zero_counts, read_counts=read_counts))
    if kws_res["faults"]:
        raise RuntimeError("cli_kws: " + "; ".join(kws_res["faults"]))
    kws_launches = kws_res["launches"]

    emit({"kernels": [
        {"name": "batched_table_gather", "route": "cuda",
         "source": "old_kaldi_git_tpu_torch/ops/csrc/gather.cu",
         "replaces": "old_kaldi_git_tpu/ops/gather_kernel.py:57",
         "launches": (k1_launches + g_launches["gather"] + c_launches["gather"]
                      + l_launches + r_launches["gather"] + iv_launches["gather"]
                      + civ_launches["gather"] + s_launches["stream"]["gather"]
                      + s_launches["stream_chain"]["gather"] + o_launches["gather"]
                      + sum(a["gather"] for a in a_launches.values())
                      + ty_launches["gather"]
                      + sum(t["gather"] for t in tr_launches.values())
                      + y_launches["gather"] + tl_launches["gather"]
                      + sd_launches["gather"]
                      + sum(n["gather"] for p in (ce_launches, ch_launches, ci_launches,
                                                  cv_launches) for n in p.values())
                      + sum(p["gather"] for p in (tiv_launches, ng_launches, cb_launches))
                      + sum(p["gather"] for p in cfg2_launches.values())
                      + sum(p["gather"] for p in seq_launches.values())
                      + lo_launches["gather"]
                      + sum(p["gather"] for p in arch_launches.values())
                      + cli_launches["gather"] + lat_launches["gather"]
                      + trn_launches["gather"] + nn3_launches["gather"]
                      + sum(p["gather"] for p in sg_launches.values())
                      + sp_launches["gather"] + kws_launches["gather"]),
         "launches_by_path": {"decode": k1_launches, "decode_gmm": g_launches["gather"],
                              "decode_chain": c_launches["gather"],
                              "decode_chain_lattice": l_launches,
                              "rescore": r_launches["gather"],
                              "decode_ivec": iv_launches["gather"],
                              "decode_chain_ivec": civ_launches["gather"],
                              "stream": s_launches["stream"]["gather"],
                              "stream_chain": s_launches["stream_chain"]["gather"],
                              "online2": o_launches["gather"],
                              **{n: a["gather"] for n, a in a_launches.items()},
                              "train_yesno": ty_launches["gather"],
                              **{n: t["gather"] for n, t in tr_launches.items()},
                              "decode_toy": y_launches["gather"],
                              "toy_lattice": tl_launches["gather"],
                              "stream_dense": sd_launches["gather"],
                              **{f"{name}_{n}": c["gather"] for name, p in (
                                  ("train_ce", ce_launches), ("train_chain", ch_launches),
                                  ("train_ce_ivec", ci_launches),
                                  ("train_chain_ivec", cv_launches))
                                 for n, c in p.items()},
                              "train_ivector": tiv_launches["gather"],
                              "train_ng": ng_launches["gather"],
                              "combine": cb_launches["gather"],
                              **{n: p["gather"] for n, p in cfg2_launches.items()},
                              **{n: p["gather"] for n, p in seq_launches.items()},
                              "lattice_outputs": lo_launches["gather"],
                              **{n: p["gather"] for n, p in arch_launches.items()},
                              "cli": cli_launches["gather"],
                              "cli_lattice": lat_launches["gather"],
                              "cli_train": trn_launches["gather"],
                              "cli_nnet3": nn3_launches["gather"],
                              **{n: p["gather"] for n, p in sg_launches.items()},
                              "cli_spkid": sp_launches["gather"],
                              "cli_kws": kws_launches["gather"]},
         "max_abs_err": max(k1_err, k1_align_err, k1_trained_chain_err, cli_res["k1_err"],
                            trn_res["k1_err"]),
         "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms, "bound_by": "bytes",
         "library_ms": k1_lib_ms,
         "at_other_shapes": {"decode_chain": k1_chain, "rescore": k1_rescore,
                             "decode_ivec": k1_ivec, "stream": k1_stream,
                             "stream_chain": k1_stream_chain,
                             **{f"{n}_{k}": v for n, g in k1_align.items()
                                for k, v in g.items()},
                             **{f"train_yesno_{k}": v for k, v in k1_yesno.items()},
                             "train_chain_decode": k1_trained_chain, **seq["k1"],
                             **lo["k1"], **{f"cli_{k}": v for k, v in cli_res["k1"].items()},
                             **trn_res["k1"]}},
        {"name": "fused_mfcc_from_frames", "route": "cuda",
         "source": "old_kaldi_git_tpu_torch/ops/csrc/mfcc.cu",
         "replaces": "old_kaldi_git_tpu/ops/mfcc_kernel.py:73",
         "launches": (k2_launches + g_launches["mfcc"] + c_launches["mfcc"]
                      + r_launches["mfcc"] + iv_launches["mfcc"] + civ_launches["mfcc"]
                      + s_launches["stream"]["mfcc"] + s_launches["stream_chain"]["mfcc"]
                      + o_launches["mfcc"] + sum(a["mfcc"] for a in a_launches.values())
                      + ty_launches["mfcc"] + sum(t["mfcc"] for t in tr_launches.values())
                      + y_launches["mfcc"] + tl_launches["mfcc"] + sd_launches["mfcc"]
                      + sum(n["mfcc"] for p in (ce_launches, ch_launches, ci_launches,
                                                cv_launches) for n in p.values())
                      + sum(p["mfcc"] for p in (tiv_launches, ng_launches, cb_launches))
                      + sum(p["mfcc"] for p in cfg2_launches.values())
                      + sum(p["mfcc"] for p in seq_launches.values())
                      + lo_launches["mfcc"]
                      + sum(p["mfcc"] for p in arch_launches.values())
                      + cli_launches["mfcc"] + lat_launches["mfcc"] + trn_launches["mfcc"]
                      + nn3_launches["mfcc"] + sum(p["mfcc"] for p in sg_launches.values())
                      + sp_launches["mfcc"] + kws_launches["mfcc"]),
         "launches_by_path": {"decode": k2_launches, "decode_gmm": g_launches["mfcc"],
                              "decode_chain": c_launches["mfcc"],
                              "rescore": r_launches["mfcc"],
                              "decode_ivec": iv_launches["mfcc"],
                              "decode_chain_ivec": civ_launches["mfcc"],
                              "stream": s_launches["stream"]["mfcc"],
                              "stream_chain": s_launches["stream_chain"]["mfcc"],
                              "online2": o_launches["mfcc"],
                              **{n: a["mfcc"] for n, a in a_launches.items()},
                              "train_yesno": ty_launches["mfcc"],
                              **{n: t["mfcc"] for n, t in tr_launches.items()},
                              "decode_toy": y_launches["mfcc"],
                              "toy_lattice": tl_launches["mfcc"],
                              "stream_dense": sd_launches["mfcc"],
                              **{f"{name}_{n}": c["mfcc"] for name, p in (
                                  ("train_ce", ce_launches), ("train_chain", ch_launches),
                                  ("train_ce_ivec", ci_launches),
                                  ("train_chain_ivec", cv_launches))
                                 for n, c in p.items()},
                              "train_ivector": tiv_launches["mfcc"],
                              "train_ng": ng_launches["mfcc"],
                              "combine": cb_launches["mfcc"],
                              **{n: p["mfcc"] for n, p in cfg2_launches.items()},
                              **{n: p["mfcc"] for n, p in seq_launches.items()},
                              "lattice_outputs": lo_launches["mfcc"],
                              **{n: p["mfcc"] for n, p in arch_launches.items()},
                              "cli": cli_launches["mfcc"],
                              "cli_lattice": lat_launches["mfcc"],
                              "cli_train": trn_launches["mfcc"],
                              "cli_nnet3": nn3_launches["mfcc"],
                              **{n: p["mfcc"] for n, p in sg_launches.items()},
                              "cli_spkid": sp_launches["mfcc"],
                              "cli_kws": kws_launches["mfcc"]},
         "launches_by_route": {r: k2_routes[r] + g_routes[r] + sum(
             p["mfcc_by_route"][r] for p in (
                 c_launches, r_launches, iv_launches, civ_launches,
                 s_launches["stream"], s_launches["stream_chain"], o_launches,
                 *a_launches.values(), ty_launches, *tr_launches.values(), y_launches,
                 tl_launches, sd_launches, *ce_launches.values(), *ch_launches.values(),
                 *ci_launches.values(), *cv_launches.values(), tiv_launches, ng_launches,
                 cb_launches, *cfg2_launches.values(), *seq_launches.values(),
                 lo_launches, *arch_launches.values(), cli_launches, lat_launches,
                 trn_launches, nn3_launches, *sg_launches.values(), sp_launches,
                 kws_launches))
             for r in k2_routes},
         "max_abs_err": max(k2_err, y_err, k2_yesno_err,
                            *(v["max_abs_err"] for v in k2_vtln.values())), "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": "operations" if k2_ops_ms >= k2_bytes_ms else "bytes",
         "library_ms": None,
         "at_other_shapes": {"decode_toy": k2_toy, "train_yesno": k2_yesno,
                             **{f"vtln_warp_{w}": v for w, v in k2_vtln.items()}}},
        {"name": "gmm_loglikes", "route": "cuda",
         "source": "old_kaldi_git_tpu_torch/ops/csrc/gmm.cu",
         "replaces": "old_kaldi_git_tpu/ops/gmm_kernel.py:125",
         "launches": (k3_tdnn_launches + g_launches["gmm"]
                      + sum(a["gmm"] for a in a_launches.values())
                      + ty_launches["gmm"] + sum(t["gmm"] for t in tr_launches.values())
                      + sum(p["gmm"] for p in cfg2_launches.values())
                      + sum(p["gmm"] for p in seq_launches.values())
                      + lo_launches["gmm"] + cli_launches["gmm"] + lat_launches["gmm"]
                      + trn_launches["gmm"] + nn3_launches["gmm"]),
         "launches_by_path": {"decode": k3_tdnn_launches,
                              "decode_gmm": g_launches["gmm"],
                              **{n: a["gmm"] for n, a in a_launches.items()},
                              "train_yesno": ty_launches["gmm"],
                              **{n: t["gmm"] for n, t in tr_launches.items()},
                              **{n: p["gmm"] for n, p in cfg2_launches.items()},
                              **{n: p["gmm"] for n, p in seq_launches.items()},
                              "lattice_outputs": lo_launches["gmm"],
                              "cli": cli_launches["gmm"],
                              "cli_lattice": lat_launches["gmm"],
                              "cli_train": trn_launches["gmm"],
                              "cli_nnet3": nn3_launches["gmm"]},
         "max_abs_err": max([k3_err] + [v["max_abs_err"] for v in k3_align.values()]
                            + [v["max_abs_err"] for v in k3_train.values()]
                            + [v["max_abs_err"] for v in k3_depths.values()]
                            + [v["max_abs_err"] for v in seq["k3"].values()]
                            + [v["max_abs_err"] for v in lo["k3"].values()]
                            + [v["max_abs_err"] for v in cli_res["k3"].values()]
                            + [v["max_abs_err"] for v in lat_res["k3"].values()]
                            + [v["max_abs_err"] for v in trn_res["k3"].values()]),
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": max(k3_ops_ms, k3_bytes_ms),
         "bound_by": "operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
         "library_ms": None,
         "at_other_shapes": {**k3_align, **{f"train_{k}": v for k, v in k3_train.items()},
                             **{f"depth_{k}": v for k, v in k3_depths.items()},
                             **seq["k3"], **lo["k3"], **cli_res["k3"], **lat_res["k3"],
                             **trn_res["k3"]}},
    ]})
    if args.noisy:
        waves, text = minilib.make_test_set(minilib.MinilibOptions(),
                                            noise=minilib.NOISE_EVAL)
        hyps = minilib.decode_test_set(system, waves, BEAM, MAX_ACTIVE,
                                       ACOUSTIC_SCALE, BATCH)
        stats = compute_wer({k: list(v) for k, v in text.items()}, hyps)
        errs = {k: edit_distance(text[k], hyps[k]).errors for k in sorted(text)}
        emit({"phase": "decode_noisy", "card": card, "noise": minilib.NOISE_EVAL,
              "wer_percent": stats.wer, "errors": stats.errors,
              "ref_words": stats.ref_len,
              "errors_by_utterance": {k: e for k, e in errs.items() if e}})
        nwer, _ = minilib.decode_and_score_chain(
            chain, beam=BEAM, max_active=CHAIN_MAX_ACTIVE, batch=CHAIN_BATCH,
            noise=minilib.NOISE_EVAL)
        nstats = minilib.decode_and_score_chain.last_stats
        emit({"phase": "decode_chain_noisy", "card": card, "noise": minilib.NOISE_EVAL,
              "wer_percent": nwer, "errors": nstats["errors"],
              "ref_words": nstats["ref_words"],
              "utterances_with_errors": nstats["utterances_with_errors"]})
        for name, decode, target, kw in (
                ("decode_ivec_noisy", minilib.decode_and_score, system,
                 {"use_ivectors": True}),
                ("decode_chain_ivec_noisy", minilib.decode_and_score_chain, chain_iv, {})):
            nwer, _ = decode(target, beam=BEAM, max_active=IVEC_MAX_ACTIVE,
                             batch=IVEC_BATCH, noise=minilib.NOISE_EVAL, **kw)
            emit({"phase": name, "card": card, "noise": minilib.NOISE_EVAL,
                  "wer_percent": nwer,
                  **{k: v for k, v in decode.last_stats.items() if k != "wer"}})
            hold_to_cpu_errors(name, decode.last_stats)

    # last, because the profiler stays attached to the process and slows
    # every later launch
    if args.profile_frames > 0:
        vopts = ViterbiOptions(beam=BEAM, max_active=MAX_ACTIVE,
                               acoustic_scale=ACOUSTIC_SCALE)
        emit({"phase": "search_profile", "card": card, **search_profile(
            torch, lambda ll, nf: decode_batch_tokens(system.csr, ll, nf, vopts),
            system.am.loglikes_batch(x), nf, args.profile_frames)})

    emit({"phase": "total", "card": card,
          "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
