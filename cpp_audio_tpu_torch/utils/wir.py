"""WIR (Waves impulse response) container support.

The reference converts .wir files to .wav by passing them through its WAV
reader, which recognizes the Waves IR container as a variant header followed
by float32 samples (source/main.wir_2_wav.cpp). A .wir file is a RIFF-style
container whose leading chunk id is 'wvIR' instead of 'WAVE'; the fmt/data
layout matches WAV with IEEE float samples.
"""

from __future__ import annotations

import struct

import numpy as np

from . import wav as wavio


def read_wir(path) -> tuple[np.ndarray, int]:
    """Read a .wir impulse response -> (float array (frames, channels), rate)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12:
        raise ValueError(f"{path}: too short for a wir file")
    if blob[0:4] == b"RIFF" and blob[8:12] in (b"wvIR", b"WIR ", b"WAVE"):
        # RIFF container with a wvIR form type: parse like wav
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
            elif cid == b"data":
                data_raw = body
            pos += 8 + csize + (csize & 1)
        if fmt_tag is None or data_raw is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        data = wavio._decode_data(data_raw, fmt_tag, bits, n_channels)
        return data, sample_rate
    raise ValueError(f"{path}: not a recognized wir container")


def wir_to_wav(src, dst, *, bits: int = 32) -> None:
    """Convert .wir -> .wav (the `wir_2_wav` app)."""
    data, sr = read_wir(src)
    wavio.write_wav(dst, data, sr, bits=bits, fmt=wavio.WAVE_FORMAT_IEEE_FLOAT)


def write_wir(path, data, sample_rate: int) -> None:
    """Write a float32 wvIR container (for round-trip tooling/tests)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    payload = data.astype("<f4").tobytes()
    n_channels = data.shape[1]
    block_align = n_channels * 4
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"wvIR")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, wavio.WAVE_FORMAT_IEEE_FLOAT,
                                      n_channels, sample_rate,
                                      sample_rate * block_align, block_align, 32))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)
