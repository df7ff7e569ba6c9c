"""Kaldi data-directory model (counterpart of
old_kaldi_git_tpu/utils/data_dir.py).

Parity with reference egs/wsj/s5/utils/{validate_data_dir.sh,split_data.sh,
fix_data_dir.sh,spk2utt_to_utt2spk.pl}: a directory holding parallel per-
utterance maps (wav.scp, text, utt2spk, optional segments/utt2dur/feats.scp/
cmvn.scp) with sorted, consistent keys.  Splitting for N-way parallelism is
kept for host-sharded input pipelines.  Host code only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("data")


def _read_map(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            key, _, rest = ln.partition(" ")
            if key in out:
                raise KaldiError(f"duplicate key {key} in {path}")
            out[key] = rest.strip()
    return out


def _write_map(path: str, mapping: Dict[str, str]) -> None:
    with open(path, "w") as f:
        for key in sorted(mapping):
            f.write(f"{key} {mapping[key]}\n")


class DataDir:
    """Loads and validates a data directory."""

    def __init__(self, path: str, require_text: bool = True):
        self.path = path
        self.wav_scp = _read_map(os.path.join(path, "wav.scp")) if os.path.exists(
            os.path.join(path, "wav.scp")
        ) else {}
        self.text = _read_map(os.path.join(path, "text")) if os.path.exists(
            os.path.join(path, "text")
        ) else {}
        self.utt2spk = _read_map(os.path.join(path, "utt2spk")) if os.path.exists(
            os.path.join(path, "utt2spk")
        ) else {}
        self.feats_scp = _read_map(os.path.join(path, "feats.scp")) if os.path.exists(
            os.path.join(path, "feats.scp")
        ) else {}
        self.segments = _read_map(os.path.join(path, "segments")) if os.path.exists(
            os.path.join(path, "segments")
        ) else {}
        if require_text and not self.text and not self.wav_scp:
            raise KaldiError(f"{path}: neither text nor wav.scp present")
        self.validate(require_text=require_text)

    # -- derived -----------------------------------------------------------
    @property
    def utts(self) -> List[str]:
        base = self.utt2spk or self.wav_scp or self.text or self.feats_scp
        return sorted(base.keys())

    @property
    def spk2utt(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for utt, spk in self.utt2spk.items():
            out.setdefault(spk, []).append(utt)
        for v in out.values():
            v.sort()
        return out

    def validate(self, require_text: bool = True) -> None:
        utts = set(self.utts)
        for name, mapping in (
            ("wav.scp", self.wav_scp),
            ("text", self.text),
            ("utt2spk", self.utt2spk),
            ("feats.scp", self.feats_scp),
        ):
            if mapping and set(mapping) != utts:
                missing = utts.symmetric_difference(mapping)
                raise KaldiError(
                    f"{self.path}/{name}: key mismatch ({len(missing)} differ, "
                    f"e.g. {sorted(missing)[:3]})"
                )

    # -- construction ------------------------------------------------------
    @staticmethod
    def create(
        path: str,
        wav_scp: Optional[Dict[str, str]] = None,
        text: Optional[Dict[str, str]] = None,
        utt2spk: Optional[Dict[str, str]] = None,
        feats_scp: Optional[Dict[str, str]] = None,
    ) -> "DataDir":
        os.makedirs(path, exist_ok=True)
        if wav_scp:
            _write_map(os.path.join(path, "wav.scp"), wav_scp)
        if text:
            _write_map(os.path.join(path, "text"), text)
        if utt2spk:
            _write_map(os.path.join(path, "utt2spk"), utt2spk)
            spk2utt: Dict[str, str] = {}
            for utt in sorted(utt2spk):
                spk = utt2spk[utt]
                spk2utt[spk] = (spk2utt.get(spk, "") + " " + utt).strip()
            _write_map(os.path.join(path, "spk2utt"), spk2utt)
        if feats_scp:
            _write_map(os.path.join(path, "feats.scp"), feats_scp)
        return DataDir(path, require_text=text is not None)

    def split(self, n: int) -> List[List[str]]:
        """Shard utterances into n contiguous, speaker-respecting groups
        (reference utils/split_data.sh default keeps speakers together)."""
        shards: List[List[str]] = [[] for _ in range(n)]
        spk2utt = self.spk2utt or {u: [u] for u in self.utts}
        sizes = [0] * n
        for spk in sorted(spk2utt):
            i = min(range(n), key=lambda j: sizes[j])
            shards[i].extend(spk2utt[spk])
            sizes[i] += len(spk2utt[spk])
        return [sorted(s) for s in shards]
