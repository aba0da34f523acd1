"""Preset + offline-job JSON, byte-compatible with the reference.

Format (source/rt.resynth.lib.params.cpp:55-212): a preset is five name->value
maps keyed by value type ("bool_params", "enum_params", "int32_params",
"uint64_params", "float_params"); a job config has preset_file /
input_voice_file / input_carrier_file / output_file / post ("none"|"limit").

Parameter names match RtResynth::saveAsPreset (rt.resynth.lib.cpp:1941-2148),
so presets saved by the reference load here unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields

from ..utils.midi import Note
from . import autotune as at
from .pitch import PitchReductionMethod, VolumeReductionMethod  # noqa: F401

_AUTOTUNE_TYPES = [at.AutotuneType.MUSICAL_SCALE, at.AutotuneType.CHORD,
                   at.AutotuneType.FIXED_SIZE_INTERVALS]
_SCALE_MODES = [at.MusicalScaleMode.MAJOR, at.MusicalScaleMode.MINOR_NATURAL,
                at.MusicalScaleMode.MINOR_HARMONIC]
_CHORD_FREQS = [at.AutotuneChordFrequencies.SINGLE_FREQ,
                at.AutotuneChordFrequencies.HARMONICS,
                at.AutotuneChordFrequencies.OCTAVE_PERIODIC]


@dataclass
class ResynthPreset:
    """All tunables of the RtResynth application (rt.resynth.lib.cpp:943-999)."""

    pitch_wheel_multiplier: float = 2.0
    window_size_seconds: float = 0.1814
    window_center_stride_seconds: float = 0.09
    min_volume: float = 0.0001
    nearby_distance_tones: float = 0.4
    max_track_pitches: float = 1.0
    autotune_tolerance_pitches: float = 100.0
    pitch_shift_pre_autotune: float = 0.0
    pitch_shift_post_autotune: float = 0.0
    pitch_harmonize_pre_autotune: float = 0.0
    pitch_harmonize_post_autotune: float = 0.0
    stereo_spread: float = 1.0
    env_attack_seconds: float = 0.0
    env_hold_seconds: float = 0.0
    env_decay_seconds: float = 0.0
    env_release_seconds: float = 0.0
    env_sustain_level: float = 1.0
    use_autotune: bool = False
    autotune_max_pitch: int = 150
    autotune_factor: int = 2
    autotune_root_note_halftones_transpose: int = 0
    autotune_bit_chord: int = 0b10010001
    autotune_type: at.AutotuneType = at.AutotuneType.MUSICAL_SCALE
    autotune_musical_scale_mode: at.MusicalScaleMode = at.MusicalScaleMode.MAJOR
    autotune_musical_scale_root_note: Note = Note.Do
    autotune_chord_frequencies: at.AutotuneChordFrequencies = at.AutotuneChordFrequencies.HARMONICS
    vocoder_carrier_noise_volume: float = 0.0
    vocoder_carrier_saw_volume: float = 0.0
    vocoder_carrier_triangle_volume: float = 0.0
    vocoder_carrier_square_volume: float = 1.0
    vocoder_carrier_sine_volume: float = 0.0
    vocoder_carrier_pulse_volume: float = 0.0
    vocoder_carrier_pulse_width: float = 0.01
    vocoder_env_follower_cutoff_ratio: float = 1.0 / 20.0
    vocoder_modulator_window_size_seconds: float = 0.10
    vocoder_stride_seconds: float = 0.005
    vocoder_count_bands: int = 5
    vocoder_min_freq: float = 100.0
    vocoder_max_freq: float = 20000.0
    voice_volume: float = 0.0
    carrier_volume: float = 0.1
    vocoder_volume: float = 0.0
    analysis_volume: float = 0.0
    analysis_input_gain: float = 1.0
    analysis_output_feedback_gain: float = 0.0
    output_delay_seconds: float = 1.0

    _BOOL = ("use_autotune",)
    _ENUM = ("autotune_type", "autotune_musical_scale_mode",
             "autotune_musical_scale_root_note", "autotune_chord_frequencies")
    _INT32 = ("autotune_max_pitch", "autotune_factor",
              "autotune_root_note_halftones_transpose", "vocoder_count_bands")
    _UINT64 = ("autotune_bit_chord",)

    def _enum_to_int(self, name: str) -> int:
        v = getattr(self, name)
        if name == "autotune_type":
            return _AUTOTUNE_TYPES.index(v)
        if name == "autotune_musical_scale_mode":
            return _SCALE_MODES.index(v)
        if name == "autotune_chord_frequencies":
            return _CHORD_FREQS.index(v)
        return int(v)  # Note

    def _enum_from_int(self, name: str, i: int):
        if name == "autotune_type":
            return _AUTOTUNE_TYPES[i]
        if name == "autotune_musical_scale_mode":
            return _SCALE_MODES[i]
        if name == "autotune_chord_frequencies":
            return _CHORD_FREQS[i]
        return Note(i)

    def to_json_dict(self) -> dict:
        b, e, i32, u64, f = {}, {}, {}, {}, {}
        for fld in fields(self):
            name = fld.name
            if name in self._BOOL:
                b[name] = bool(getattr(self, name))
            elif name in self._ENUM:
                e[name] = self._enum_to_int(name)
            elif name in self._INT32:
                i32[name] = int(getattr(self, name))
            elif name in self._UINT64:
                u64[name] = int(getattr(self, name))
            else:
                f[name] = float(getattr(self, name))
        return {"bool_params": b, "enum_params": e, "int32_params": i32,
                "uint64_params": u64, "float_params": f}

    @classmethod
    def from_json_dict(cls, d: dict) -> "ResynthPreset":
        p = cls()
        for name, v in d.get("bool_params", {}).items():
            if hasattr(p, name):
                setattr(p, name, bool(v))
        for name, v in d.get("enum_params", {}).items():
            if hasattr(p, name):
                setattr(p, name, p._enum_from_int(name, int(v)))
        for src in ("int32_params", "uint64_params"):
            for name, v in d.get(src, {}).items():
                if hasattr(p, name):
                    setattr(p, name, int(v))
        for name, v in d.get("float_params", {}).items():
            if hasattr(p, name):
                setattr(p, name, float(v))
        return p

    def save(self, path) -> None:
        with open(path, "w") as fp:
            json.dump(self.to_json_dict(), fp, indent=2)

    @classmethod
    def load(cls, path) -> "ResynthPreset":
        with open(path) as fp:
            return cls.from_json_dict(json.load(fp))


@dataclass
class OfflineJobConfig:
    """rt.resynth.lib.params.cpp:183-212."""

    preset_file: str = ""
    input_voice_file: str = ""
    input_carrier_file: str = ""
    output_file: str = ""
    post: str = "none"  # "none" | "limit"

    def to_json_dict(self) -> dict:
        return {
            "preset_file": self.preset_file,
            "input_voice_file": self.input_voice_file,
            "input_carrier_file": self.input_carrier_file,
            "output_file": self.output_file,
            "post": self.post,
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "OfflineJobConfig":
        # voice-only jobs may omit the carrier / post keys
        return cls(
            preset_file=d["preset_file"],
            input_voice_file=d.get("input_voice_file", ""),
            input_carrier_file=d.get("input_carrier_file", ""),
            output_file=d["output_file"],
            post=d.get("post", d.get("postprocessing", "none")),
        )

    def save(self, path) -> None:
        with open(path, "w") as fp:
            json.dump(self.to_json_dict(), fp, indent=2)

    @classmethod
    def load(cls, path) -> "OfflineJobConfig":
        with open(path) as fp:
            return cls.from_json_dict(json.load(fp))


class PresetAutosaver:
    """Background preset autosave + restore-on-launch.

    Reference (rt.resynth.lib.cpp:1124-1161): RtResynth writes the current
    preset to `autosave.json` every second from a dedicated thread and
    restores that file at startup when present.

    get_preset: callable returning the current ResynthPreset (polled each
    interval; writes only when the JSON changed).
    """

    AUTOSAVE_NAME = "autosave.json"

    def __init__(self, get_preset, directory, *, interval_seconds: float = 1.0):
        import os

        self.get_preset = get_preset
        self.path = os.path.join(str(directory), self.AUTOSAVE_NAME)
        self.interval = interval_seconds
        self._stop = None
        self._thread = None
        self._last = None
        self.saves = 0

    def restore(self):
        """Load the autosaved preset if one exists (call before start())."""
        import os

        if os.path.exists(self.path):
            return ResynthPreset.load(self.path)
        return None

    def save_once(self) -> bool:
        import json as _json

        d = self.get_preset().to_json_dict()
        blob = _json.dumps(d, indent=2)
        if blob == self._last:
            return False
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fp:
            fp.write(blob)
        import os

        os.replace(tmp, self.path)
        self._last = blob
        self.saves += 1
        return True

    def start(self):
        import threading

        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.save_once()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self._thread

    def stop(self):
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
