"""ctypes bindings for the native (C++) host components in native/.

Copied from cpp_audio_tpu/native.py, trimmed to the components this package
uses: the per-frame pitch pipeline (native/pitchpipe.cpp,
rt.resynth.lib.algo.cpp stages) and its fused offline table packer, the
lock-free SPSC float queue (native/ringbuffer.cpp) and the exact WIND
control walks (native/windwalk.cpp). It loads the repo's own library
(NATIVE_DIR, shared with the JAX package).

The library auto-builds on first use (g++ via native/Makefile); callers fall
back to the pure-Python implementations if no compiler is available.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
LIB_PATH = NATIVE_DIR / "libcppaudio_native.so"

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)
_I64P = ctypes.POINTER(ctypes.c_int64)
_FP = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def load_library():
    """Build (if needed) and load the native library; None on failure."""
    try:
        if not LIB_PATH.exists() or any(
            p.stat().st_mtime > LIB_PATH.stat().st_mtime
            for p in NATIVE_DIR.glob("*.cpp")
        ):
            subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(LIB_PATH))
    except Exception:
        return None

    lib.pitchpipe_create.restype = ctypes.c_void_p
    lib.pitchpipe_create.argtypes = [_DP, ctypes.c_int, _DP, _DP, ctypes.c_int,
                                     _DP, ctypes.c_int]
    lib.pitchpipe_destroy.argtypes = [ctypes.c_void_p]
    lib.pitchpipe_dropped.restype = ctypes.c_int64
    lib.pitchpipe_dropped.argtypes = [ctypes.c_void_p]
    lib.pitchpipe_process_frame.restype = ctypes.c_int
    lib.pitchpipe_process_frame.argtypes = [
        ctypes.c_void_p, _DP, _DP, ctypes.c_int,
        _IP, _I64P, _DP, _DP, ctypes.c_int,
    ]
    lib.pitchpipe_set_scale.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                        _DP, ctypes.c_int, _DP, ctypes.c_int]
    lib.pitchpipe_run_offline.restype = ctypes.c_int64
    lib.pitchpipe_run_offline.argtypes = [
        ctypes.c_void_p, _DP, _DP, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, _DP, ctypes.c_int64,
        _DP, ctypes.c_int64, _FP,
    ]

    lib.ringbuffer_create.restype = ctypes.c_void_p
    lib.ringbuffer_create.argtypes = [ctypes.c_uint64]
    lib.ringbuffer_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("ringbuffer_capacity", "ringbuffer_size", "ringbuffer_dropped"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.ringbuffer_push.restype = ctypes.c_uint64
    lib.ringbuffer_push.argtypes = [ctypes.c_void_p, _FP, ctypes.c_uint64]
    lib.ringbuffer_pop.restype = ctypes.c_uint64
    lib.ringbuffer_pop.argtypes = [ctypes.c_void_p, _FP, ctypes.c_uint64]

    lib.wind_long_walk.argtypes = [_FP, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int32, ctypes.c_int,
                                   ctypes.c_longlong, _FP]
    lib.wind_short_walk.argtypes = [_FP, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, _FP, ctypes.c_longlong,
                                    _FP]
    lib.wind_long_walk_from.argtypes = [_FP, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int32,
                                        ctypes.c_int, ctypes.c_longlong, _FP]
    lib.wind_short_walk_from.argtypes = [_FP, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_float, _FP,
                                         ctypes.c_longlong, _FP]
    return lib


def available() -> bool:
    return load_library() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_DP)


class NativePitchPipe:
    """Stateful per-frame pitch pipeline (see native/pitchpipe.cpp)."""

    MAX_EVENTS = 1024

    def __init__(self, *, nearby_distance_tones, min_volume, max_track_pitches,
                 shift_pre, shift_post, harmonize_pre, harmonize_post,
                 autotune_max_pitch, autotune_tolerance, pitch_method: int,
                 volume_method: int, max_voices: int, analysis_volume: float,
                 loud_pitches, loud_spl, allowed_pitches=None):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        cfg = np.ascontiguousarray(
            [nearby_distance_tones, min_volume, max_track_pitches, shift_pre,
             shift_post, harmonize_pre, harmonize_post, autotune_max_pitch,
             autotune_tolerance, float(pitch_method), float(volume_method),
             float(max_voices), analysis_volume], dtype=np.float64)
        lp = np.ascontiguousarray(loud_pitches, np.float64)
        ls = np.ascontiguousarray(loud_spl, np.float64)
        allowed = (np.ascontiguousarray(allowed_pitches, np.float64)
                   if allowed_pitches is not None else np.zeros(0))
        self._ctx = lib.pitchpipe_create(_dp(cfg), len(cfg), _dp(lp), _dp(ls),
                                         len(lp), _dp(allowed), len(allowed))
        self._keepalive = (cfg, lp, ls, allowed)
        self._kind = np.zeros(self.MAX_EVENTS, np.int32)
        self._scale_keepalive = None
        self._nid = np.zeros(self.MAX_EVENTS, np.int64)
        self._freq = np.zeros(self.MAX_EVENTS, np.float64)
        self._vol = np.zeros(self.MAX_EVENTS, np.float64)

    def set_scale(self, root_pitch: float, scale_pitches, equidistant) -> None:
        sp = np.ascontiguousarray(scale_pitches, np.float64)
        eq = np.ascontiguousarray(equidistant, np.float64)
        self._scale_keepalive = (sp, eq)
        self._lib.pitchpipe_set_scale(self._ctx, float(root_pitch),
                                      _dp(sp), len(sp), _dp(eq), len(eq))

    def process_frame(self, freqs, mags_db):
        freqs = np.ascontiguousarray(freqs, np.float64)
        mags = np.ascontiguousarray(mags_db, np.float64)
        n = self._lib.pitchpipe_process_frame(
            self._ctx, _dp(freqs), _dp(mags), len(freqs),
            self._kind.ctypes.data_as(_IP), self._nid.ctypes.data_as(_I64P),
            _dp(self._freq), _dp(self._vol), self.MAX_EVENTS,
        )
        return (self._kind[:n].copy(), self._nid[:n].copy(),
                self._freq[:n].copy(), self._vol[:n].copy())

    @property
    def dropped(self) -> int:
        return int(self._lib.pitchpipe_dropped(self._ctx))

    def run_offline(self, freqs, mags_db, *, stride: int, n_slots: int,
                    total_frames: int, sample_rate: float,
                    attack: float, hold: float, decay: float, sustain: float,
                    release: float, stereo_spread: float,
                    pan_draws, phase_draws) -> tuple[np.ndarray, int]:
        """Fused offline tracking + slot-table build (pitchpipe_run_offline).

        freqs/mags_db: (n_frames, k) f64 device peak arrays (invalid entries
        marked by non-finite mag). Returns ((total_frames, n_slots, 16) f32
        control table for models/resynth_bank._render_slots, n_tracked_notes).
        """
        freqs = np.ascontiguousarray(freqs, np.float64)
        mags = np.ascontiguousarray(mags_db, np.float64)
        n_frames, k = freqs.shape
        pan = np.ascontiguousarray(pan_draws, np.float64)
        ph = np.ascontiguousarray(phase_draws, np.float64)
        table = np.empty((total_frames, n_slots, 16), np.float32)
        n = self._lib.pitchpipe_run_offline(
            self._ctx, _dp(freqs), _dp(mags), n_frames, k,
            int(stride), int(n_slots), int(total_frames), float(sample_rate),
            float(attack), float(hold), float(decay), float(sustain),
            float(release), float(stereo_spread),
            _dp(pan), len(pan), _dp(ph), len(ph),
            table.ctypes.data_as(_FP),
        )
        if n < 0:
            raise RuntimeError("pitchpipe_run_offline failed (draw pool too small?)")
        return table, int(n)

    def __del__(self):
        try:
            self._lib.pitchpipe_destroy(self._ctx)
        except Exception:
            pass


class RingBuffer:
    """Lock-free SPSC float queue (native/ringbuffer.cpp)."""

    def __init__(self, min_capacity: int):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._rb = lib.ringbuffer_create(min_capacity)

    def push(self, data) -> int:
        data = np.ascontiguousarray(data, np.float32).reshape(-1)
        return int(self._lib.ringbuffer_push(self._rb, data.ctypes.data_as(_FP),
                                             len(data)))

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = int(self._lib.ringbuffer_pop(self._rb, out.ctypes.data_as(_FP), n))
        return out[:got]

    @property
    def size(self) -> int:
        return int(self._lib.ringbuffer_size(self._rb))

    @property
    def capacity(self) -> int:
        return int(self._lib.ringbuffer_capacity(self._rb))

    @property
    def dropped(self) -> int:
        return int(self._lib.ringbuffer_dropped(self._rb))

    def __del__(self):
        try:
            self._lib.ringbuffer_destroy(self._rb)
        except Exception:
            pass


def wind_long_walk(table, start_pos: int, n_slow_steps: int, itp_kind: int,
                   n_out: int, prev0: float | None = None) -> np.ndarray:
    """Exact Ctrl<WindFreqIter<SlowIter<AbsIter<noise>>>> per-sample values
    (native/windwalk.cpp); caller must check available().

    prev0: when given, start from the reference's real spec-start state —
    prev = prev0 (from a discarded position draw) with the iterator AT
    start_pos, unadvanced (playNextSpec's forgetPastSignals-then-
    set_sample_rate double init, sound.h:185-190). When None, the classic
    convention: prev = |table[start_pos]|, iterator at start_pos+1."""
    lib = load_library()
    table = np.ascontiguousarray(table, np.float32)
    out = np.empty(n_out, np.float32)
    if prev0 is None:
        lib.wind_long_walk(table.ctypes.data_as(_FP), len(table),
                           int(start_pos), int(n_slow_steps), int(itp_kind),
                           n_out, out.ctypes.data_as(_FP))
    else:
        lib.wind_long_walk_from(table.ctypes.data_as(_FP), len(table),
                                int(start_pos), float(prev0),
                                int(n_slow_steps), int(itp_kind), n_out,
                                out.ctypes.data_as(_FP))
    return out


def wind_short_walk(table, start_pos: int, rate: float, inc_long,
                    prev0: float | None = None) -> np.ndarray:
    """Exact short-term wobble values (SlowIter retuned per sample from the
    long-term increment, soundengine.h:134-143). prev0: see wind_long_walk."""
    lib = load_library()
    table = np.ascontiguousarray(table, np.float32)
    inc_long = np.ascontiguousarray(inc_long, np.float32)
    out = np.empty(len(inc_long), np.float32)
    if prev0 is None:
        lib.wind_short_walk(table.ctypes.data_as(_FP), len(table),
                            int(start_pos), float(rate),
                            inc_long.ctypes.data_as(_FP), len(inc_long),
                            out.ctypes.data_as(_FP))
    else:
        lib.wind_short_walk_from(table.ctypes.data_as(_FP), len(table),
                                 int(start_pos), float(prev0), float(rate),
                                 inc_long.ctypes.data_as(_FP), len(inc_long),
                                 out.ctypes.data_as(_FP))
    return out
