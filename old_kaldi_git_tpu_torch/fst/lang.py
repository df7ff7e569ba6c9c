"""Lang-directory construction: lexicon → L.fst, symbol tables, disambig.

Own copy of old_kaldi_git_tpu/fst/lang.py (without the lang-directory
reader).  L_disambig matches the JAX package's arc for arc, in the same
order and with the same disambiguation numbering: the native composition
numbers the graph's states by it.

Parity with reference egs/wsj/s5/utils/prepare_lang.sh +
utils/{add_lex_disambig.pl,make_lexicon_fst.pl}: phones/words symbol tables,
lexicon disambiguation symbols (#1..#N for homophones/prefixes, #0 for the
LM backoff), the lexicon transducer with optional inter-word silence, and a
unigram grammar (yesno-style G).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable
from old_kaldi_git_tpu_torch.fst.vector_fst import EPS, Arc, VectorFst
from old_kaldi_git_tpu_torch.utils.log import KaldiError

Pron = Tuple[str, ...]  # phone names


@dataclasses.dataclass
class Lexicon:
    """word → list of pronunciations (optionally with probabilities)."""

    entries: List[Tuple[str, float, Pron]]  # (word, prob, phones)

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "Lexicon":
        """Values may be: 'y eh s' | ['y','eh','s'] | ['y eh s', 'jh e s']
        (multiple prons) | [['y','eh','s'], ...]."""
        entries = []
        for word in sorted(d):
            value = d[word]
            if isinstance(value, str):
                prons = [tuple(value.split())]
            elif value and all(isinstance(x, str) for x in value):
                # list of strings: phone list if no spaces, else multi-pron
                if any(" " in x for x in value):
                    prons = [tuple(x.split()) for x in value]
                else:
                    prons = [tuple(value)]
            else:
                prons = [tuple(p) for p in value]
            for pron in prons:
                entries.append((word, 1.0, pron))
        return Lexicon(entries)

    @property
    def phones(self) -> List[str]:
        out = set()
        for _, _, pron in self.entries:
            out.update(pron)
        return sorted(out)

    @property
    def words(self) -> List[str]:
        return sorted({w for w, _, _ in self.entries})


def add_lex_disambig(lexicon: Lexicon) -> Tuple[List[Tuple[str, float, Pron]], int]:
    """Append disambiguation symbols (#1, #2, …) to pronunciations that are
    homophones or prefixes of other pronunciations (reference
    add_lex_disambig.pl).  Returns (new entries, max disambig index used)."""
    prons = [pron for _, _, pron in lexicon.entries]
    pron_count: Dict[Pron, int] = {}
    for p in prons:
        pron_count[p] = pron_count.get(p, 0) + 1
    prefixes = set()
    for p in prons:
        for k in range(1, len(p)):
            prefixes.add(p[:k])
    last_used: Dict[Pron, int] = {}
    new_entries: List[Tuple[str, float, Pron]] = []
    max_disambig = 0
    for word, prob, pron in lexicon.entries:
        needs = pron_count[pron] > 1 or pron in prefixes
        if not needs:
            new_entries.append((word, prob, pron))
            continue
        idx = last_used.get(pron, 0) + 1
        # homophones get distinct symbols; prefix-only needs just #1
        if pron_count[pron] == 1:
            idx = 1
        last_used[pron] = idx
        max_disambig = max(max_disambig, idx)
        new_entries.append((word, prob, pron + (f"#{idx}",)))
    return new_entries, max_disambig


class Lang:
    """The lang bundle: symbol tables + L/L_disambig + metadata."""

    def __init__(self, lexicon: Lexicon, silence_phone: str = "SIL",
                 sil_prob: float = 0.5):
        """Optional silence between words with probability sil_prob (0: no
        silence arcs); the JAX package's options for position-dependent
        phones (refused there), an unknown word and no optional silence are
        not taken."""
        self.lexicon = lexicon
        self.silence_phone = silence_phone
        self.sil_prob = sil_prob

        disambig_entries, ndisambig = add_lex_disambig(lexicon)
        # reserve one extra for #0 (LM backoff) — goes on the phone side too
        self.num_disambig = ndisambig + 1

        phone_list = sorted(set(lexicon.phones) | {silence_phone})
        self.phones = SymbolTable.with_eps()
        for p in phone_list:
            self.phones.add(p)
        self.disambig_phone_ids: List[int] = [
            self.phones.add(f"#{k}") for k in range(self.num_disambig)]

        self.words = SymbolTable.with_eps()
        for w in lexicon.words:
            self.words.add(w)
        self.word_disambig_id = self.words.add("#0")

        self._disambig_entries = disambig_entries
        self.L = self._make_lexicon_fst(use_disambig=False)
        self.L_disambig = self._make_lexicon_fst(use_disambig=True)

    # -- phone sets ------------------------------------------------------------
    @property
    def silence_id(self) -> int:
        return self.phones[self.silence_phone]

    @property
    def real_phone_ids(self) -> List[int]:
        """Non-eps, non-disambig phone ids."""
        dis = set(self.disambig_phone_ids)
        return [i for i in self.phones.ids() if i != 0 and i not in dis]

    # -- L construction ----------------------------------------------------------
    def _make_lexicon_fst(self, use_disambig: bool) -> VectorFst:
        """reference make_lexicon_fst.pl structure."""
        entries = self._disambig_entries if use_disambig else [
            (w, p, pron) for (w, p, pron) in self.lexicon.entries
        ]
        fst = VectorFst()
        start = fst.add_state()
        loop = fst.add_state()
        fst.set_start(start)
        fst.set_final(loop, 0.0)
        sil_id = self.silence_id
        sp = self.sil_prob
        no_sil_cost = -math.log(max(1.0 - sp, 1e-10)) if sp > 0 else 0.0
        sil_cost = -math.log(max(sp, 1e-10)) if sp > 0 else None

        if sp > 0:
            fst.add_arc(start, Arc(EPS, EPS, no_sil_cost, loop))
            fst.add_arc(start, Arc(sil_id, EPS, sil_cost, loop))
        else:
            fst.add_arc(start, Arc(EPS, EPS, 0.0, loop))

        if use_disambig:
            # pass the LM backoff symbol through: phone #0 : word #0
            # (reference utils/prepare_lang.sh adds this self-loop so
            # L_disambig ∘ G works with backoff arcs in G)
            fst.add_arc(
                loop,
                Arc(self.disambig_phone_ids[0], self.word_disambig_id, 0.0, loop),
            )

        def phone_id(name: str) -> int:
            if name not in self.phones:
                raise KaldiError(f"phone {name!r} missing from table")
            return self.phones[name]

        for word, prob, pron in entries:
            if not use_disambig:
                pron = tuple(p for p in pron if not p.startswith("#"))
            wid = self.words[word]
            pron_cost = -math.log(max(prob, 1e-10))
            cur = loop
            if len(pron) == 0:
                continue
            for i, ph in enumerate(pron):
                last = i == len(pron) - 1
                il = phone_id(ph)
                ol = wid if i == 0 else EPS
                w = pron_cost if i == 0 else 0.0
                if not last:
                    nxt = fst.add_state()
                    fst.add_arc(cur, Arc(il, ol, w, nxt))
                    cur = nxt
                else:
                    if sp > 0:
                        end = fst.add_state()
                        fst.add_arc(cur, Arc(il, ol, w, end))
                        fst.add_arc(end, Arc(EPS, EPS, no_sil_cost, loop))
                        fst.add_arc(end, Arc(sil_id, EPS, sil_cost, loop))
                    else:
                        fst.add_arc(cur, Arc(il, ol, w, loop))
        fst.arcsort("olabel")
        return fst


def make_unigram_grammar_fst(
    sentences: Sequence[Sequence[str]], words: SymbolTable
) -> VectorFst:
    """Word-loop unigram G estimated from transcripts (the yesno-style
    grammar; reference local/prepare_lm.sh uses a simple loop too)."""
    counts: Dict[str, int] = {}
    total = 0
    for sent in sentences:
        for w in sent:
            counts[w] = counts.get(w, 0) + 1
            total += 1
        total += 1  # end-of-sentence event
    fst = VectorFst()
    s = fst.add_state()
    fst.set_start(s)
    n_end = max(len(sentences), 1)
    fst.set_final(s, -math.log(n_end / max(total, 1)))
    for w, c in sorted(counts.items()):
        wid = words[w]
        fst.add_arc(s, Arc(wid, wid, -math.log(c / max(total, 1)), s))
    fst.arcsort("ilabel")
    return fst
