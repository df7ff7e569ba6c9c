"""RIFF WAVE reading and writing.

Own copy of old_kaldi_git_tpu/utils/wav.py (reference
src/feat/wave-reader.h, WaveData): RIFF parsing that tolerates pipe output
(a missing or overstated data size), 16- and 8-bit PCM and the G.711
A-law and µ-law codes, all read into float32 in the range of int16
(Kaldi's convention: not normalised to [-1, 1]); 16-bit PCM writing.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO

import numpy as np

from old_kaldi_git_tpu_torch.utils.log import KaldiError


@dataclasses.dataclass
class WaveData:
    samp_freq: float
    data: np.ndarray  # [num_channels, num_samples] float32, int16 range

    @property
    def duration(self) -> float:
        return self.data.shape[1] / self.samp_freq


def read_wav_stream(f: BinaryIO) -> WaveData:
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise KaldiError("not a RIFF WAVE stream")
    samp_freq = num_channels = bits = audio_fmt = data = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            break
        chunk_id, size = header[:4], struct.unpack("<I", header[4:])[0]
        if chunk_id == b"fmt ":
            fmt = f.read(size)
            audio_fmt, num_channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
            if audio_fmt not in (1, 6, 7, 0xFFFE):  # PCM, A-law, µ-law, extensible
                raise KaldiError(f"unsupported WAVE format tag {audio_fmt}")
            samp_freq = float(rate)
        elif chunk_id == b"data":
            data = f.read(size) if size != 0xFFFFFFFF else f.read()
            break
        else:
            f.read(size + (size & 1))
    if samp_freq is None or data is None:
        raise KaldiError("WAVE stream missing fmt/data chunk")
    if audio_fmt in (1, 0xFFFE):
        if bits == 16:
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
        elif bits == 8:
            # 8-bit PCM is unsigned: centred and scaled to the int16 range
            samples = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
        else:
            raise KaldiError(f"unsupported PCM bit depth {bits}")
    elif audio_fmt == 6:
        if bits != 8:
            raise KaldiError(f"ALaw must be 8-bit, got {bits}")
        samples = _ALAW_TABLE[np.frombuffer(data, dtype=np.uint8)]
    else:
        if bits != 8:
            raise KaldiError(f"µLaw must be 8-bit, got {bits}")
        samples = _MULAW_TABLE[np.frombuffer(data, dtype=np.uint8)]
    n = (len(samples) // num_channels) * num_channels
    return WaveData(samp_freq=samp_freq,
                    data=samples[:n].reshape(-1, num_channels).T.astype(np.float32))


def _build_alaw_table() -> np.ndarray:
    """G.711 A-law byte → linear int16 (the Sun/CCITT alaw2linear)."""
    out = np.zeros(256, np.float32)
    for i in range(256):
        a = i ^ 0x55
        t = (a & 0x0F) << 4
        seg = (a & 0x70) >> 4
        if seg == 0:
            t += 8
        elif seg == 1:
            t += 0x108
        else:
            t = (t + 0x108) << (seg - 1)
        out[i] = float(t if (a & 0x80) else -t)
    return out


def _build_mulaw_table() -> np.ndarray:
    """G.711 µ-law byte → linear int16 (the Sun/CCITT ulaw2linear)."""
    out = np.zeros(256, np.float32)
    for i in range(256):
        u = ~i & 0xFF
        t = (((u & 0x0F) << 3) + 0x84) << ((u & 0x70) >> 4)
        out[i] = float(0x84 - t if (u & 0x80) else t - 0x84)
    return out


_ALAW_TABLE = _build_alaw_table()
_MULAW_TABLE = _build_mulaw_table()


def write_wav_stream(f: BinaryIO, wave: WaveData) -> None:
    """16-bit PCM, the samples rounded and clipped to int16."""
    data = np.asarray(wave.data)
    if data.ndim == 1:
        data = data[None, :]
    num_channels = data.shape[0]
    pcm = np.clip(np.round(data.T), -32768, 32767).astype("<i2").tobytes()
    rate = int(wave.samp_freq)
    f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
    f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, num_channels, rate,
                                  rate * num_channels * 2, num_channels * 2, 16))
    f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


def read_wav(path_or_rx: str) -> WaveData:
    """A wave from an rxfilename (utils/kio.py: a file, a pipe, stdin)."""
    from old_kaldi_git_tpu_torch.utils.kio import Input

    with Input(path_or_rx) as f:
        return read_wav_stream(f)


def write_wav(path: str, samples: np.ndarray, samp_freq: float) -> None:
    with open(path, "wb") as f:
        write_wav_stream(f, WaveData(samp_freq=samp_freq, data=np.asarray(samples)))
