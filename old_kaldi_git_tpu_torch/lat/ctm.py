"""Word-aligned CTM output with confidences.

Own copy of old_kaldi_git_tpu/lat/ctm.py (reference src/lat):
  word_align_lattice{,-lexicon}.{h,cc} — map a lattice/alignment to per-word
      time segments (here via SplitToPhones on the Viterbi tid string and a
      lexicon walk, the word-boundary-free equivalent that the reference's
      *-lexicon variant implements);
  lattice-to-ctm-conf — best path (or MBR sausage) → CTM lines
      "utt chan start dur word conf".

Our lattices are frame-synchronous with one transition-id per frame on the
best path, so word times fall out of the alignment exactly: split the tid
string into phone segments, then consume each word's pronunciation from the
segment stream (silence segments between words are attributed to no word,
matching the reference's convention of optional-silence entries).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

from old_kaldi_git_tpu_torch.hmm.hmm_utils import split_to_phones
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.lat.lattice import Lattice, confusion_network, lattice_best_path
from old_kaldi_git_tpu_torch.utils.log import KaldiError


@dataclasses.dataclass
class CtmEntry:
    utt: str
    channel: int
    start: float  # seconds
    duration: float  # seconds
    word: str
    confidence: float = 1.0

    def line(self) -> str:
        return (
            f"{self.utt} {self.channel} {self.start:.2f} {self.duration:.2f} "
            f"{self.word} {self.confidence:.2f}"
        )


def _phone_segments(
    tm: TransitionModel, tids: Sequence[int]
) -> List[Tuple[int, int, int]]:
    """[(phone, start_frame, num_frames)] from a per-frame tid alignment."""
    segs = split_to_phones(tm, list(tids))
    out = []
    t = 0
    for seg in segs:
        phone = tm.tid_to_phone(seg[0])
        out.append((phone, t, len(seg)))
        t += len(seg)
    return out


_PRONS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _prons_by_word(lang) -> Dict[int, List[Tuple[int, ...]]]:
    """Word id → its pronunciations in phone ids, longest first (ties in
    lexicon order), built once for each lang: a lang's lexicon is not
    edited after its first alignment."""
    prons = _PRONS.get(lang)
    if prons is None:
        prons = {}
        for w_str, _prob, pron in lang.lexicon.entries:
            prons.setdefault(lang.words[w_str], []).append(
                tuple(lang.phones[p] for p in pron))
        prons = {w: sorted(ps, key=len, reverse=True) for w, ps in prons.items()}
        _PRONS[lang] = prons
    return prons


def align_words_lexicon(
    tm: TransitionModel,
    lang,
    words: Sequence[int],
    tids: Sequence[int],
) -> List[Tuple[int, int, int]]:
    """[(word, start_frame, num_frames)] — the WordAlignLatticeLexicon role.

    Walks the phone segments of the alignment, consuming one pronunciation
    of each word in turn; silence phones between words are skipped (they
    belong to no word, as with the reference's optional-silence lexicon
    entries)."""
    segs = _phone_segments(tm, tids)
    sil: Set[int] = {lang.silence_id}
    prons = _prons_by_word(lang)
    out: List[Tuple[int, int, int]] = []
    i = 0
    for w in words:
        while i < len(segs) and segs[i][0] in sil:
            i += 1
        matched = False
        for pron in prons.get(w, []):
            phones_here = tuple(p for p, _, _ in segs[i:i + len(pron)])
            if phones_here == pron:
                start = segs[i][1]
                nframes = sum(n for _, _, n in segs[i:i + len(pron)])
                out.append((w, start, nframes))
                i += len(pron)
                matched = True
                break
        if not matched:
            raise KaldiError(
                f"align_words_lexicon: word {w} does not match alignment "
                f"phones at segment {i}"
            )
    return out


def ctm_from_alignment(
    tm: TransitionModel,
    lang,
    words: Sequence[int],
    tids: Sequence[int],
    utt: str = "utt",
    channel: int = 1,
    frame_shift: float = 0.01,
    confidences: Optional[Sequence[float]] = None,
) -> List[CtmEntry]:
    """Best-path words + Viterbi tids → CTM entries (nbest-to-ctm role)."""
    aligned = align_words_lexicon(tm, lang, words, tids)
    out = []
    for k, (w, start, nframes) in enumerate(aligned):
        out.append(
            CtmEntry(
                utt, channel, start * frame_shift, nframes * frame_shift,
                lang.words[w],
                float(confidences[k]) if confidences is not None else 1.0,
            )
        )
    return out


def lattice_to_ctm_conf(
    lat: Lattice,
    tm: TransitionModel,
    lang,
    utt: str = "utt",
    lm_scale: float = 1.0,
    ac_scale: float = 0.1,
    frame_shift: float = 0.01,
    channel: int = 1,
) -> List[CtmEntry]:
    """~ lattice-to-ctm-conf: one-best words with times from the Viterbi
    alignment and confidences from the confusion network (posterior of the
    chosen word in its sausage bin; 1.0 when the bin is unambiguous)."""
    words, tids, _cost = lattice_best_path(lat, lm_scale, ac_scale)
    if not words:
        return []
    cn = confusion_network(lat, lm_scale, ac_scale)
    # greedy match: for each best-path word in order, find its posterior in
    # the next bin that contains it
    confs: List[float] = []
    bin_i = 0
    for w in words:
        conf = 1.0
        j = bin_i
        while j < len(cn):
            d = dict(cn[j])
            if w in d:
                conf = min(1.0, d[w])
                bin_i = j + 1
                break
            j += 1
        confs.append(conf)
    return ctm_from_alignment(
        tm, lang, words, tids, utt=utt, channel=channel,
        frame_shift=frame_shift, confidences=confs,
    )


def align_words_boundary(
    tm: TransitionModel,
    boundary: Dict[int, str],
    words: Sequence[int],
    tids: Sequence[int],
) -> List[Tuple[int, int, int]]:
    """[(word, start_frame, num_frames)] using word-boundary phone marks
    (reference latbin/lattice-align-words.cc + word-align-lattice.cc, which
    consume lang/phones/word_boundary.txt: per phone one of
    begin/end/internal/singleton/nonword).

    Phone segments are grouped into words: a 'singleton' phone is a whole
    word; a 'begin' phone opens a word closed by the next 'end' phone
    ('internal' phones extend it); 'nonword' phones (silence & co) belong
    to no word.  The grouped spans are paired with the word sequence in
    order."""
    segs = _phone_segments(tm, tids)
    spans: List[Tuple[int, int]] = []  # (start_frame, num_frames)
    open_start: Optional[int] = None
    open_frames = 0
    for phone, start, nframes in segs:
        kind = boundary.get(phone)
        if kind is None:
            raise KaldiError(f"phone {phone} missing from word-boundary map")
        if kind == "nonword":
            if open_start is not None:
                raise KaldiError(
                    f"nonword phone {phone} inside a word at frame {start}")
            continue
        if kind == "singleton":
            if open_start is not None:
                raise KaldiError(f"singleton phone {phone} inside a word")
            spans.append((start, nframes))
        elif kind == "begin":
            if open_start is not None:
                raise KaldiError(f"begin phone {phone} inside a word")
            open_start, open_frames = start, nframes
        elif kind == "internal":
            if open_start is None:
                raise KaldiError(f"internal phone {phone} outside a word")
            open_frames += nframes
        elif kind == "end":
            if open_start is None:
                raise KaldiError(f"end phone {phone} outside a word")
            spans.append((open_start, open_frames + nframes))
            open_start, open_frames = None, 0
        else:
            raise KaldiError(f"unknown word-boundary type {kind!r}")
    if open_start is not None:
        raise KaldiError("alignment ends inside a word")
    if len(spans) != len(words):
        raise KaldiError(
            f"{len(spans)} word spans for {len(words)} words")
    return [(w, s, n) for w, (s, n) in zip(words, spans)]


def read_word_boundary(path: str) -> Dict[int, str]:
    """lang/phones/word_boundary.int format: 'phone-id type' per line."""
    out: Dict[int, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[int(parts[0])] = parts[1]
    return out
