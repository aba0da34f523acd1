"""WAV read/write: PCM 16/24/32-bit int and 32/64-bit float, any channel count.

Equivalent of the reference's cpp.algorithms WAVReader/WAVWriter (used at e.g.
include/audio_context.h:44-71 and source/rt.resynth.lib.params.cpp for offline
jobs; fixtures under testdata/audio exercise the 16/24/32-int and 32-float
encodings). Skips unknown RIFF chunks (fact, PEAK, LIST...). Pure numpy on the
host — device code only ever sees float arrays.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    n_channels: int
    bits_per_sample: int
    format_tag: int
    n_frames: int


def _decode_data(raw: bytes, fmt: int, bits: int, n_channels: int) -> np.ndarray:
    if fmt == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float64)
        elif bits == 64:
            data = np.frombuffer(raw, dtype="<f8").astype(np.float64)
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
    elif fmt == WAVE_FORMAT_PCM:
        if bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            data = vals.astype(np.float64) / float(1 << 23)
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag: {fmt}")
    n_frames = len(data) // n_channels
    return data[: n_frames * n_channels].reshape(n_frames, n_channels)


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float64 array of shape (frames, channels), sample_rate).

    Integer PCM is normalized to [-1, 1).
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt_tag = bits = n_channels = sample_rate = None
    data_raw = None
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", blob, pos + 4)
        body = blob[pos + 8 : pos + 8 + csize]
        if cid == b"fmt ":
            fmt_tag, n_channels, sample_rate = struct.unpack_from("<HHI", body, 0)
            (bits,) = struct.unpack_from("<H", body, 14)
            if fmt_tag == WAVE_FORMAT_EXTENSIBLE and csize >= 40:
                # SubFormat GUID's first 2 bytes carry the real format tag
                (fmt_tag,) = struct.unpack_from("<H", body, 24)
        elif cid == b"data":
            data_raw = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned
    if fmt_tag is None or data_raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return _decode_data(data_raw, fmt_tag, bits, n_channels), sample_rate


def _encode_data(data: np.ndarray, fmt: int, bits: int) -> bytes:
    flat = np.asarray(data, dtype=np.float64).reshape(-1)
    if fmt == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            return flat.astype("<f4").tobytes()
        if bits == 64:
            return flat.astype("<f8").tobytes()
        raise ValueError(f"unsupported float bit depth: {bits}")
    if fmt == WAVE_FORMAT_PCM:
        clipped = np.clip(flat, -1.0, 1.0 - 1e-9)
        if bits == 16:
            return (clipped * 32768.0).astype("<i2").tobytes()
        if bits == 24:
            vals = (clipped * float(1 << 23)).astype(np.int32)
            out = np.empty((len(vals), 3), dtype=np.uint8)
            out[:, 0] = vals & 0xFF
            out[:, 1] = (vals >> 8) & 0xFF
            out[:, 2] = (vals >> 16) & 0xFF
            return out.tobytes()
        if bits == 32:
            return (clipped * float(1 << 31)).astype("<i4").tobytes()
        raise ValueError(f"unsupported PCM bit depth: {bits}")
    raise ValueError(f"unsupported WAV format tag: {fmt}")


def write_wav(path, data, sample_rate: int, *, bits: int = 32,
              fmt: int = WAVE_FORMAT_IEEE_FLOAT) -> None:
    """Write (frames,) or (frames, channels) float data to a WAV file.

    Defaults to float32 like the reference's rt.resynth offline output
    (source/rt.resynth.lib.params.cpp: stereo float32 output).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_frames, n_channels = data.shape
    payload = _encode_data(data, fmt, bits)
    block_align = n_channels * bits // 8
    byte_rate = sample_rate * block_align
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt, n_channels, sample_rate,
                            byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


class StreamingWavWriter:
    """Incremental WAV writer: append frames, finalize sizes on close.

    Host-side analog of the reference's AsyncWavWriter signal taps
    (include/audio_platforms.h:119-225) — here writes happen off the device
    path entirely, so no queue is needed; blocks are appended as they leave
    the accelerator.
    """

    def __init__(self, path, sample_rate: int, n_channels: int, *, bits: int = 32,
                 fmt: int = WAVE_FORMAT_IEEE_FLOAT):
        self._f = open(path, "wb")
        self._fmt = fmt
        self._bits = bits
        self._n_channels = n_channels
        self._n_payload = 0
        block_align = n_channels * bits // 8
        self._f.write(b"RIFF" + struct.pack("<I", 0) + b"WAVE")
        self._f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, n_channels,
                                            sample_rate, sample_rate * block_align,
                                            block_align, bits))
        self._f.write(b"data" + struct.pack("<I", 0))

    def append(self, frames) -> None:
        frames = np.asarray(frames)
        if frames.ndim == 1:
            frames = frames[:, None]
        assert frames.shape[1] == self._n_channels
        payload = _encode_data(frames, self._fmt, self._bits)
        self._f.write(payload)
        self._n_payload += len(payload)

    def close(self) -> None:
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + self._n_payload))
        self._f.seek(40)
        self._f.write(struct.pack("<I", self._n_payload))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def filter_frames(in_path, out_path, keep_fn) -> None:
    """Rewrite a WAV keeping only frames for which keep_fn(frame) is True.

    Equivalent of the cpp.algorithms `filter_frames` used by
    source/main.join_non_zeros.cpp.
    """
    data, sr = read_wav(in_path)
    mask = np.array([bool(keep_fn(fr)) for fr in data])
    write_wav(out_path, data[mask], sr)
