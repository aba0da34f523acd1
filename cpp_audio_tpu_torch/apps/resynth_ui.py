"""Terminal dashboard for the analysis/resynthesis/vocoder pipeline — the
headless analog of the reference's wxWidgets UI.

Reference (source/rt.resynth.ui.cpp:7 and siblings): `MyFrame` shows param
sliders grouped and colored by section, a `PitchWindow` scrolling view of the
played notes (rt.resynth.ui.analysis.cpp:14), a `VocoderWindow` of live band
envelopes (rt.resynth.ui.vocoder.cpp:16), an autotune widget block, and
polled gauges (CPU load, queue fill, per-stage durations).

Here the same data feeds render as text: a pitch roll (time x MIDI pitch,
volume-shaded), vocoder band envelope rows, the grouped parameter panel, and
the per-stage duration gauges — driven from a WAV, since this environment
has no audio devices. `--live` runs the UI's polling-timer shape: the input
streams through LiveResynth and the dashboard refreshes periodically while
accepting live param edits and preset save/load on stdin (live_dashboard).

Usage:
  python -m cpp_audio_tpu_torch.apps.resynth_ui input.wav [--vocoder] [--width 100]
  python -m cpp_audio_tpu_torch.apps.resynth_ui input.wav --live

Port of cpp_audio_tpu/apps/resynth_ui.py: the analysis runs on --device
(default cuda), and each stage gauge synchronises the device before its
clock is read, so it times the stage's device work, not its dispatch.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

SHADES = " .:-=+*#%@"


def shade(v: float) -> str:
    """Map 0..1 to an ASCII intensity character."""
    i = int(np.clip(v, 0.0, 1.0) * (len(SHADES) - 1) + 0.5)
    return SHADES[i]


def pitch_roll(tracked, n_frames: int, *, width: int = 100,
               height: int = 24) -> str:
    """The PitchWindow analog: tracked notes on a (pitch, time) grid,
    brightness = volume (reference rt.resynth.ui.analysis.cpp:14)."""
    if not tracked:
        return "(no notes)"
    vmax_all = max(v for tn in tracked for (_, _, v) in tn.frames) or 1.0
    pitches = [69.0 + 12.0 * np.log2(max(freq, 1e-9) / 440.0)
               for tn in tracked for (_, freq, v) in tn.frames
               if v >= 0.02 * vmax_all]  # range from audible notes only
    if not pitches:
        return "(no audible notes)"
    lo = np.floor(min(pitches)) - 1
    hi = np.ceil(max(pitches)) + 1
    grid = np.zeros((height, width))
    col = lambda f: min(int(f * width / max(n_frames, 1)), width - 1)
    row = lambda p: int((hi - p) / (hi - lo + 1e-9) * (height - 1))
    for tn in tracked:
        end = min(tn.release_frame, n_frames)
        frames = tn.frames + [(end, tn.frames[-1][1], tn.frames[-1][2])]
        for (f0, freq, vol), (f1, _, _) in zip(frames[:-1], frames[1:]):
            p = 69.0 + 12.0 * np.log2(max(freq, 1e-9) / 440.0)
            if not (lo <= p <= hi):
                continue  # sub-threshold artifacts excluded from the range
            r = row(p)
            for c in range(col(f0), max(col(f1), col(f0) + 1)):
                grid[r, c] = max(grid[r, c], vol / vmax_all)
    lines = []
    for r in range(height):
        p = hi - (hi - lo) * r / (height - 1)
        label = f"{p:6.1f} |" if r % 4 == 0 else "       |"
        lines.append(label + "".join(shade(v) for v in grid[r]))
    lines.append("       +" + "-" * width)
    return "\n".join(lines)


def vocoder_bands(band_amps: np.ndarray, band_freqs: np.ndarray,
                  *, width: int = 100) -> str:
    """The VocoderWindow analog: one shaded row per band over time
    (reference rt.resynth.ui.vocoder.cpp:16)."""
    n_frames, n_bands = band_amps.shape
    edges = np.linspace(0, n_frames, width + 1).astype(int)
    vmax = band_amps.max() or 1.0
    lines = []
    for b in reversed(range(n_bands)):
        vals = [band_amps[a:c, b].max() if c > a else 0.0
                for a, c in zip(edges[:-1], edges[1:])]
        lines.append(f"{band_freqs[b]:7.0f}Hz |"
                     + "".join(shade(v / vmax) for v in vals))
    return "\n".join(lines)


PARAM_GROUPS = {
    "analysis": ["window_size_seconds", "window_center_stride_seconds",
                 "min_volume", "analysis_volume", "max_voices"],
    "pitch": ["nearby_distance_tones", "max_track_pitches",
              "pitch_shift_pre_autotune", "pitch_shift_post_autotune",
              "pitch_harmonize_pre_autotune", "pitch_harmonize_post_autotune",
              "pitch_method", "volume_method"],
    "autotune": ["use_autotune", "autotune_max_pitch",
                 "autotune_tolerance_pitches", "autotune_kwargs"],
    "envelope": ["env_attack_seconds", "env_hold_seconds", "env_decay_seconds",
                 "env_release_seconds", "env_sustain_level"],
    "output": ["stereo_spread", "sample_rate", "dtype", "seed"],
}


def param_panel(config) -> str:
    """Grouped parameter listing (the MyFrame slider sections analog,
    reference rt.resynth.ui.cpp param sections colored by group)."""
    d = dataclasses.asdict(config)
    out = []
    for group, names in PARAM_GROUPS.items():
        out.append(f"[{group}]")
        for n in names:
            if n in d:
                v = d[n]
                v = getattr(v, "name", v)
                out.append(f"  {n:32s} = {v}")
    return "\n".join(out)


def _parse_value(s: str):
    if s in ("true", "True"):
        return True
    if s in ("false", "False"):
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def _preset_from_config(cfg):
    """ResynthConfig -> ResynthPreset for the matching field names
    (the UI's save-preset menu, rt.resynth.ui.cpp)."""
    import dataclasses as dc

    from ..analysis.presets_json import ResynthPreset

    p = ResynthPreset()
    names = {f.name for f in dc.fields(ResynthPreset)}
    for f in dc.fields(cfg):
        if f.name in names:
            setattr(p, f.name, getattr(cfg, f.name))
    return p


def _apply_preset_to_config(preset, cfg):
    import dataclasses as dc

    names = {f.name for f in dc.fields(cfg)}
    for f in dc.fields(preset):
        if f.name in names:
            setattr(cfg, f.name, getattr(preset, f.name))


def live_dashboard(mono, sr, *, stdin=None, stdout=None, config=None,
                   block_size: int = 4096, blocks_per_refresh: int = 4,
                   width: int = 100, height: int = 16, device="cuda") -> dict:
    """Refresh loop over a streaming analysis with live param editing — the
    reference UI's polling timer + param sliders + preset menu
    (rt.resynth.ui.cpp:7, rt.resynth.ui.params.cpp).

    The input streams through LiveResynth block by block; every
    `blocks_per_refresh` blocks the dashboard redraws (params, pitch window,
    note counters, gauges) and ONE command line is read from stdin:

      set <param> <value>   mutate a ResynthConfig field live (applies to
                            subsequent analysis frames, like the reference's
                            atomic param setters)
      save <path>           write the current params as a JSON preset
      load <path>           restore params from a JSON preset
      quit                  stop streaming

    Returns a stats dict (refreshes, commands applied, windows analyzed).
    The stream runs on `device`.
    """
    import io

    from ..analysis import resynth as resynth_mod
    from ..analysis.autotune import mk_autotune_function
    from ..analysis.streaming import LiveResynth

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    cfg = config or resynth_mod.ResynthConfig(sample_rate=sr)
    live = LiveResynth(cfg, device=device)
    stats = {"refreshes": 0, "commands": 0, "windows": 0, "quit": False}

    def refresh():
        stats["refreshes"] += 1
        tracked = list(live.tracker.voices.values())
        print("=== parameters ===", file=stdout)
        print(param_panel(cfg), file=stdout)
        print("=== pitch window ===", file=stdout)
        print(pitch_roll(tracked, max(live.tracker.frame_idx, 1),
                         width=width, height=height), file=stdout)
        s = live.stats
        print(f"windows={s.windows} on={s.note_on} change={s.note_change} "
              f"off={s.note_off} dropped={s.dropped_note_on}", file=stdout)

    def poll_command() -> None:
        line = stdin.readline()
        if not line:
            return
        parts = line.split()
        if not parts:
            return
        cmd = parts[0]
        if cmd == "quit":
            stats["quit"] = True
        elif cmd == "set" and len(parts) >= 3:
            name, value = parts[1], _parse_value(parts[2])
            if not hasattr(cfg, name):
                print(f"unknown param {name}", file=stdout)
                return
            setattr(cfg, name, value)
            if name.startswith(("use_autotune", "autotune")):
                live.tracker.autotune_fn = mk_autotune_function(
                    use_autotune=cfg.use_autotune, **cfg.autotune_kwargs)
            stats["commands"] += 1
            print(f"set {name} = {value}", file=stdout)
        elif cmd == "save" and len(parts) >= 2:
            _preset_from_config(cfg).save(parts[1])
            stats["commands"] += 1
            print(f"saved preset {parts[1]}", file=stdout)
        elif cmd == "load" and len(parts) >= 2:
            from ..analysis.presets_json import ResynthPreset

            _apply_preset_to_config(ResynthPreset.load(parts[1]), cfg)
            live.tracker.autotune_fn = mk_autotune_function(
                use_autotune=cfg.use_autotune, **cfg.autotune_kwargs)
            stats["commands"] += 1
            print(f"loaded preset {parts[1]}", file=stdout)
        else:
            print(f"unknown command: {line.strip()}", file=stdout)

    mono = np.asarray(mono, np.float64)
    bi = 0
    for i in range(0, len(mono), block_size):
        if stats["quit"]:
            break
        live.feed(mono[i : i + block_size])
        live.pull(min(block_size, len(mono) - i))
        bi += 1
        if bi % blocks_per_refresh == 0:
            refresh()
            poll_command()
    refresh()
    stats["windows"] = live.stats.windows
    return stats


def _timed(stages, name: str, t0: float, dev: torch.device) -> None:
    """Record a stage gauge: synchronise the device, then read the clock."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages.record(name, time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", help="input WAV (the microphone analog)")
    ap.add_argument("--vocoder", action="store_true",
                    help="also show the vocoder band-envelope window")
    ap.add_argument("--live", action="store_true",
                    help="refresh loop over a streaming analysis with live "
                         "param editing (set/save/load/quit on stdin)")
    ap.add_argument("--width", type=int, default=100)
    ap.add_argument("--height", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device the analysis runs on")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    if args.live:
        from ..utils import wav

        data, sr = wav.read_wav(args.input)
        mono = data.mean(axis=1) if data.ndim == 2 else data
        stats = live_dashboard(mono, sr, width=args.width,
                               height=min(args.height, 20), device=dev)
        print(f"done: {stats['windows']} windows, "
              f"{stats['commands']} commands")
        return 0

    from ..analysis import resynth
    from ..analysis import vocoder as voc
    from ..utils import wav
    from ..utils.profiling import StageDurations

    data, sr = wav.read_wav(args.input)
    mono = data.mean(axis=1) if data.ndim == 2 else data
    cfg = resynth.ResynthConfig(sample_rate=sr)
    stages = StageDurations()

    t0 = time.perf_counter()
    peaks = resynth.analyze(mono, cfg, device=dev)
    _timed(stages, "fft+peaks", t0, dev)
    t0 = time.perf_counter()
    # python tracker: it also returns the per-frame AnalysisFrameResult feed
    # (the NonRealtimeAnalysisFrame analog) that the note counters need
    tracked, frame_stats, dropped = resynth.track(peaks, cfg,
                                                  prefer_native=False)
    stages.record("pitch pipeline", time.perf_counter() - t0)

    print("=== parameters " + "=" * (args.width - 7))
    print(param_panel(cfg))
    print()
    print("=== pitch window (notes) " + "=" * (args.width - 17))
    print(pitch_roll(tracked, len(peaks), width=args.width, height=args.height))
    n_on = sum(s.note_on for s in frame_stats)
    n_off = sum(s.note_off for s in frame_stats)
    n_chg = sum(s.note_change for s in frame_stats)
    print(f"frames={len(peaks)} notes: on={n_on} change={n_chg} off={n_off} "
          f"dropped={dropped}")

    if args.vocoder:
        params = voc.VocoderParams(sample_rate=sr)
        edges = params.band_freqs()
        n_vf = max(1, (len(mono) - params.modulator_window) // params.stride + 1)
        t0 = time.perf_counter()
        amps = voc._modulator_band_amps_fast(
            torch.as_tensor(mono, dtype=torch.float32, device=dev), edges,
            window=params.modulator_window, stride=params.stride,
            n_frames=n_vf, sample_rate=sr,
            shape=params.modulator_window_shape)
        _timed(stages, "vocoder bands", t0, dev)
        amps = amps.cpu().numpy()
        print()
        print("=== vocoder window (band envelopes) " + "=" * (args.width - 28))
        print(vocoder_bands(amps, edges[:-1], width=args.width))

    print()
    print("=== stage durations (UI gauges) ===")
    for stage, info in stages.summary().items():
        print(f"  {stage:20s} {1e3 * info['last']:9.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
