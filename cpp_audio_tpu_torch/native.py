"""ctypes bindings for the native (C++) host components in native/.

Copied from cpp_audio_tpu/native.py, trimmed to the component this package
uses so far: the per-frame pitch pipeline (native/pitchpipe.cpp,
rt.resynth.lib.algo.cpp stages) and its fused offline table packer. It
loads the repo's own library (NATIVE_DIR, shared with the JAX package).

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
