"""The `tune` app: score playground with synth presets from text files
(reference source/main.tune.cpp — oscillator synths defined by
synth/Envelope*.txt + Harmonics*.txt + LowPass.txt, scores via parseMusic).

  python -m cpp_audio_tpu_torch.apps.tune "do re mi-- fa" out.wav --synth-dir synth/
  python -m cpp_audio_tpu_torch.apps.tune "do re mi-- fa" out.wav --synth-dir synth/ --play
      streams the piece block by block and hot-reloads the preset files by
      mtime while it plays (main.tune.cpp:1941-2031)

Port of cpp_audio_tpu/apps/tune.py: the synths render on --device (default
cuda; the harmonics synth through the voice-bank kernel there), and each
render is copied to the host once, for the WAV.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..core import voices
from ..models import harmonics
from ..utils import presets, score
from ..utils import wav as wavio


def render_notes(notes, *, synth_dir=None, sample_rate: int = 44100,
                 envelope_file: str = "EnvelopeFast.txt",
                 harmonics_file: str = "Harmonics.txt",
                 lowpass_file: str = "LowPass.txt",
                 sample_files: list | None = None, device="cuda"):
    """Render a note list with the oscillator synth, or — when `sample_files`
    maps frequencies to WAVs ("440=pluck.wav") — with the sampler synth
    (reference TuneSamplerElement, main.tune.cpp:108,1710-1790).
    Returns ((n, channels) tensor on `device`, sample_rate)."""
    total = int(max((n.release for n in notes), default=0) + sample_rate)

    if sample_files:
        from ..models import sampler as smp
        from ..utils import wav as wavio

        smap = smp.SampleMap()
        for spec_str in sample_files:
            freq_s, path = spec_str.split("=", 1)
            data, sr2 = wavio.read_wav(path)
            mono = data.mean(axis=1)
            smap.add_for_frequency(float(freq_s), sample_rate,
                                   smp.trim_sample(mono))
        scfg = smp.SamplerConfig(sample_rate=sample_rate)
        if synth_dir is not None:
            ah = presets.parse_envelope_file(Path(synth_dir) / envelope_file,
                                             sample_rate)
            scfg = smp.SamplerConfig(sample_rate=sample_rate, ahdsr=ah)
        return smp.render_notes(notes, smap, total, scfg, device=device), sample_rate

    if synth_dir is not None:
        d = Path(synth_dir)
        ahdsr = presets.parse_envelope_file(d / envelope_file, sample_rate)
        vols = tuple(presets.parse_harmonics_file(d / harmonics_file))
        lp = presets.parse_lowpass_file(d / lowpass_file)
    else:
        ahdsr, vols, lp = None, (1.0, 0.5, 0.25), 800.0
    cfg = harmonics.HarmonicsSynthConfig(
        sample_rate=sample_rate, ahdsr=ahdsr, harmonic_volumes=vols,
        lowpass_freq=lp,
    )
    pad = 8 * max(1, -(-len(notes) // 8))
    sch = voices.schedule_from_notes(notes, pad_to=min(pad, 64))
    return harmonics.render_schedule(sch, total, cfg, device=device), sample_rate


def score_to_notes(score_text: str, *, sample_rate: int = 44100,
                   time_unit_ms: float = 180.0, octave: int = 4):
    specs = score.parse_music(score_text)
    return score.notespecs_to_notes(specs, sample_rate=sample_rate,
                                    time_unit_ms=time_unit_ms, octave=octave)


def render_score(score_text: str, *, synth_dir=None, sample_rate: int = 44100,
                 time_unit_ms: float = 180.0, octave: int = 4,
                 sample_files: list | None = None, device="cuda", **kw):
    notes = score_to_notes(score_text, sample_rate=sample_rate,
                           time_unit_ms=time_unit_ms, octave=octave)
    return render_notes(notes, synth_dir=synth_dir, sample_rate=sample_rate,
                        sample_files=sample_files, device=device, **kw)


class SynthDirWatcher:
    """mtime watcher over the synth preset files (reference
    main.tune.cpp:1941-2031 — pollValueChanges on Envelope*/Harmonics*/
    LowPass text files during playback)."""

    def __init__(self, synth_dir, files):
        self.dir = Path(synth_dir)
        self.files = list(files)
        self._mtimes = self._stat()

    def _stat(self):
        out = {}
        for f in self.files:
            p = self.dir / f
            try:
                out[f] = p.stat().st_mtime_ns
            except OSError:
                out[f] = None
        return out

    def changed(self) -> bool:
        cur = self._stat()
        if cur != self._mtimes:
            self._mtimes = cur
            return True
        return False


def play_streaming(notes, out_path, *, synth_dir, sample_rate: int = 44100,
                   block_seconds: float = 0.25, on_block=None,
                   envelope_file: str = "EnvelopeFast.txt",
                   harmonics_file: str = "Harmonics.txt",
                   lowpass_file: str = "LowPass.txt",
                   realtime: bool = False, device="cuda"):
    """Block-streaming playback with preset hot reload by mtime.

    The reference's tune app polls the synth definition files during playback
    and re-applies envelope/harmonics/low-pass to the live synths when a file
    changes (main.tune.cpp:1941-2031). Here each block checks the watcher;
    on a change the remainder of the piece re-renders under the new config
    (phases are closed-form in the press sample, so oscillator phase is
    continuous across the reload seam; envelope/harmonics changes step at the
    seam like the reference's setAHDSR on live elements).

    on_block(block_index, t_samples): called after each written block (tests
    edit preset files from here). Returns (n_reloads, total_samples).
    Each full render is copied to the host once and streamed from there.
    """
    import time as time_mod

    out_path = Path(out_path)
    total = int(max((n.release for n in notes), default=0) + sample_rate)
    block = max(1, int(block_seconds * sample_rate))
    watcher = SynthDirWatcher(
        synth_dir, [envelope_file, harmonics_file, lowpass_file])

    def full_render():
        out, _sr = render_notes(
            notes, synth_dir=synth_dir, sample_rate=sample_rate,
            envelope_file=envelope_file, harmonics_file=harmonics_file,
            lowpass_file=lowpass_file, device=device)
        return out.cpu().numpy()

    rendered = full_render()
    writer = wavio.StreamingWavWriter(out_path, sample_rate,
                                      rendered.shape[1])
    reloads = 0
    t = 0
    bi = 0
    try:
        while t < total:
            if watcher.changed():
                rendered = full_render()
                reloads += 1
            end = min(t + block, total)
            writer.append(rendered[t:end])
            t = end
            bi += 1
            if on_block is not None:
                on_block(bi, t)
            if realtime:
                time_mod.sleep(block / sample_rate)
    finally:
        writer.close()
    return reloads, total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("score", nargs="?", default=None,
                    help="score string, or @file to read one")
    ap.add_argument("output", nargs="?", default="tune.wav")
    ap.add_argument("--synth-dir", default=None,
                    help="directory with Envelope*/Harmonics*/LowPass presets")
    ap.add_argument("--time-unit-ms", type=float, default=180.0)
    ap.add_argument("--octave", type=int, default=4)
    ap.add_argument("--sample", action="append", default=None,
                    metavar="FREQ=WAV",
                    help="use the sampler synth with this pitched sample "
                         "(repeatable), e.g. --sample 440=pluck.wav")
    # second simultaneous voice (reference two-voice pieces,
    # main.tune.cpp:2430-2578 playFeuillardTwoVoices*)
    ap.add_argument("--score2", default=None,
                    help="second simultaneous voice (score string or @file)")
    ap.add_argument("--octave2", type=int, default=None)
    # built-in two-voice demo piece (the reference ships two-voice demo
    # renders, main.tune.cpp:2430-2578; this one is an original)
    ap.add_argument("--demo", action="store_true",
                    help="render the built-in two-voice demo piece")
    # event streams (reference main.tune.cpp:193-1017)
    ap.add_argument("--rain", type=float, default=None, metavar="SECONDS",
                    help="render the rain event stream instead of a score")
    ap.add_argument("--sonify", default=None, metavar="FILE",
                    help="sonify the bytes of FILE instead of a score")
    ap.add_argument("--sonify-full", action="store_true",
                    help="use the reference's full sonification machinery "
                         "(skip lists, batch interestingness selection, "
                         "cyclic byte->pitch maps — main.tune.cpp:469-1017) "
                         "instead of the condensed histogram mapping")
    ap.add_argument("--polyphony", type=int, default=1,
                    help="with --sonify-full: simultaneous voices reading "
                         "the byte stream (Polyphony, main.tune.cpp:853-861)")
    ap.add_argument("--modulo-pitch", action="store_true",
                    help="fold pitches into [50, 80] by octaves "
                         "(moduloPitch, main.tune.cpp:2439-2461)")
    ap.add_argument("--loop", type=int, default=None, metavar="N",
                    help="loop the score N times")
    ap.add_argument("--loop-pitch-offset", type=float, default=0.0,
                    help="half-tones added per loop iteration")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--play", action="store_true",
                    help="block-streaming playback with preset hot reload "
                         "by mtime (main.tune.cpp:1941-2031): edit the "
                         "--synth-dir files while it runs")
    ap.add_argument("--realtime", action="store_true",
                    help="with --play: pace blocks at the sample rate")
    ap.add_argument("--device", default="cuda",
                    help="torch device the synths render on (default cuda)")
    args = ap.parse_args(argv)

    from ..utils import event_streams

    if args.demo:
        if args.score is not None and args.output == "tune.wav":
            args.output = args.score
        args.score = "do mi sol Do- si la sol- fa mi re do- mi sol- do--"
        args.score2 = "do-- mi-- sol-- fa- sol- do---"
        args.octave2 = args.octave - 1

    # `tune --rain 3 out.wav`: the positional grabs the output path
    if (args.rain is not None or args.sonify is not None) \
            and args.score is not None:
        if args.output == "tune.wav":
            args.output = args.score
        args.score = None

    sr = 44100
    try:
        if args.rain is not None:
            notes = event_streams.rain_notes(args.rain, sample_rate=sr,
                                             seed=args.seed)
        elif args.sonify is not None:
            blob = Path(args.sonify).read_bytes()
            if args.sonify_full:
                notes = event_streams.binary_sonification_notes_full(
                    blob, polyphony=args.polyphony, sample_rate=sr)
                if args.loop:
                    period = max((n.release for n in notes), default=0)
                    notes = event_streams.loop_notes(
                        notes, args.loop, period,
                        pitch_offset_per_iteration=args.loop_pitch_offset)
            else:
                notes = event_streams.binary_sonification_notes(
                    blob, sample_rate=sr)
            if args.modulo_pitch:
                notes = event_streams.modulo_pitch_notes(notes)
        elif args.score is not None:
            text = args.score
            if text.startswith("@"):
                text = Path(text[1:]).read_text()
            notes = score_to_notes(text, sample_rate=sr,
                                   time_unit_ms=args.time_unit_ms,
                                   octave=args.octave)
            if args.loop:
                period = max((n.release for n in notes), default=0)
                notes = event_streams.loop_notes(
                    notes, args.loop, period,
                    pitch_offset_per_iteration=args.loop_pitch_offset)
            if args.score2 is not None:
                text2 = args.score2
                if text2.startswith("@"):
                    text2 = Path(text2[1:]).read_text()
                notes2 = score_to_notes(
                    text2, sample_rate=sr, time_unit_ms=args.time_unit_ms,
                    octave=args.octave2 if args.octave2 is not None
                    else args.octave)
                import dataclasses

                base = max((n.note_id for n in notes), default=0) + 1
                notes = notes + [dataclasses.replace(n, note_id=base + i)
                                 for i, n in enumerate(notes2)]
        else:
            ap.error("need a score, --rain, or --sonify")
        if args.play:
            if args.synth_dir is None:
                ap.error("--play needs --synth-dir (it watches its files)")
            reloads, total = play_streaming(
                notes, args.output, synth_dir=args.synth_dir, sample_rate=sr,
                realtime=args.realtime, device=args.device)
            print(f"wrote {args.output} (streamed {total} samples, "
                  f"{reloads} preset reloads)")
            return 0
        out, sr = render_notes(notes, synth_dir=args.synth_dir,
                               sample_rate=sr, sample_files=args.sample,
                               device=args.device)
    except ValueError as e:
        ap.error(str(e))
    wavio.write_wav(args.output, out.cpu().numpy(), sr)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
