"""Lattices the port's lattice-output tests share (a helper, not a test
module).

`yesno_lattices`: the yes/no toy (tests/test_online.py's graph) decoded by
the port's decode_batch lattice mode on loglikes synthesised from known
phone sequences at a weak separation plus noise, so that the lattices hold
competing words; each lattice is copied arc for arc into the JAX
package's Lattice, so both packages read the same numbers.
`final_word_lattices`: bench.py's toy graph, whose final states carry
words (`final_olabels`), decoded the same way, with the decoder's words
and its end state's words (ROADMAP queue 3: the lattice-building
functions of both packages drop those).  Conversions between the
packages' lattice types and exact-comparison tuples."""

import dataclasses
from typing import List

import numpy as np

import old_kaldi_git_tpu.fst.lang as jlang
import old_kaldi_git_tpu.hmm.topology as jtopo
import old_kaldi_git_tpu.hmm.transition_model as jtm_mod
import old_kaldi_git_tpu.lat.determinize as jdet
import old_kaldi_git_tpu.lat.lattice as jlat
import old_kaldi_git_tpu.tree.context_dep as jcd
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.lat.lattice as tlat
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.fst.lang import Lang, Lexicon
from old_kaldi_git_tpu_torch.recipes import toy
from tests.test_online import _loglikes_for, _toy_decode_system
from tests.test_torch_chain import port_graph
from tests.test_torch_dense_lattice import SEQUENCES, _end_state_words
from tests.test_torch_lattice_post import to_jax
from tests.test_torch_lattice_rebuild import compact_lattice_tuple as clat_tuple

DECODE = dict(beam=30.0, max_active=200, acoustic_scale=1.0)
YESNO_LEXICON = {"yes": "Y EH S", "no": "N OW"}


@dataclasses.dataclass
class ToyLattices:
    jlang: object  # the JAX package's Lang
    tlang: Lang  # the port's, from the same lexicon
    jtm: object
    ttm: object
    port: List[tlat.Lattice]
    jax: List[jlat.Lattice]
    words: List[List[int]]  # the decoder's words
    tails: List[List[int]]  # the end state's final words (not in the lattice)


def clat_to_jax(clat):
    out = jdet.CompactLattice()
    for _ in range(clat.num_states):
        out.add_state()
    out.start = clat.start
    out.finals = list(clat.finals)
    out.arcs = [[jdet.CompactLatticeArc(a.word, a.graph_cost, a.acoustic_cost, tuple(a.tids),
                                        a.nextstate) for a in lst] for lst in clat.arcs]
    return out


def lat_tuple(lat):
    return (lat.start, list(lat.finals), list(lat.state_time),
            [[(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost, a.nextstate)
              for a in lst] for lst in lat.arcs])


def _decode(tg, ll, nf, lattice_beam):
    res = tvit.decode_batch(tg, ll, nf, tvit.ViterbiOptions(**DECODE), want_lattice=True,
                            device="cpu")
    lats, words, tails = [], [], []
    for b, r in enumerate(res):
        lats.append(tlat.lattice_from_decode(tg, ll[b, : nf[b]], r.frame_states,
                                             r.frame_costs, 1.0, lattice_beam=lattice_beam))
        words.append(list(r.words))
        tails.append(_end_state_words(tg, r))
    return lats, words, tails


def yesno_lattices(sep: float = 1.5, noise: float = 0.6, seed: int = 3,
                   lattice_beam: float = 10.0) -> ToyLattices:
    lang, _topo, cd, jtm, jg = _toy_decode_system()
    rng = np.random.default_rng(seed)
    lls = [_loglikes_for(jtm, cd, lang, s, sep=sep) for s in SEQUENCES]
    T = max(len(x) for x in lls)
    ll = np.full((len(lls), T, cd.num_pdfs), -sep, np.float32)
    for i, x in enumerate(lls):
        ll[i, : len(x)] = x + noise * rng.normal(size=x.shape).astype(np.float32)
    nf = np.asarray([len(x) for x in lls], np.int32)
    lats, words, tails = _decode(port_graph(jg), ll, nf, lattice_beam)
    tlang = Lang(Lexicon.from_dict(YESNO_LEXICON), silence_phone="SIL", sil_prob=0.5)
    return ToyLattices(lang, tlang, jtm, convert.transition_model_from_pickle(jtm), lats,
                       [to_jax(x) for x in lats], words, tails)


def final_word_lattices(num: int = 6, seed: int = 5) -> ToyLattices:
    """bench.py's toy graph (final states with words) on synthetic loglikes
    of random sentences."""
    system = toy.build_toy_system(device="cpu")
    rng = np.random.default_rng(toy.SEED)
    lexicon = toy.toy_lexicon(rng)
    jl = jlang.Lang(jlang.Lexicon.from_dict(lexicon), silence_phone="SIL", sil_prob=0.5)
    phones = jl.real_phone_ids
    topo = jtopo.HmmTopology.standard(phones, silence_phones=[jl.silence_id])
    jtm = jtm_mod.TransitionModel(
        jcd.monophone_context_dependency(phones, {p: topo.num_pdf_classes(p) for p in phones}),
        topo)
    rng = np.random.default_rng(seed)
    vocab = sorted(w for w in system.lang.words.symbols() if w.startswith("w"))
    sents = [[vocab[i] for i in rng.integers(0, len(vocab), rng.integers(2, 7))]
             for _ in range(num)]
    ll, nf = toy.synthetic_loglikes(system, sents, seed=seed + 1)
    lats, words, tails = _decode(system.csr, ll, nf, 8.0)
    return ToyLattices(jl, system.lang, jtm, system.tm, lats, [to_jax(x) for x in lats],
                       words, tails)
