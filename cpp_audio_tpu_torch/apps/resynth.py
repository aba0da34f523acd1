"""The `resynth` / `rt.resynth.job` apps.

  python -m cpp_audio_tpu_torch.apps.resynth input.wav output.wav
      offline analysis -> resynthesis (reference main.resynth.cpp)
  python -m cpp_audio_tpu_torch.apps.resynth --job job.json
      headless JSON job (reference rt.resynth.job scheme,
      rt.resynth.lib.params.cpp:183-389)
  python -m cpp_audio_tpu_torch.apps.resynth input.wav output.wav --live
      block-streaming duplex loop (the realtime RtResynth shape: input fed
      block-by-block through PeriodicFFT into the live tracker + streaming
      synth, output pulled per block — rt.resynth.lib.cpp:1185-1235)
  python -m cpp_audio_tpu_torch.apps.resynth input.wav output.wav --live \
          --midi events.mid --carrier saw=0.8,noise=0.2
      live loop with the MIDI-playable vocoder carrier synth: the MIDI file
      drives the osc-mix carrier (models/carrier.py), the live input
      modulates it through the streaming vocoder, and both the resynth
      voices and the vocoded carrier mix into the output (the reference's
      full RtResynth application loop — rt.resynth.lib.cpp:212-221,
      1397-1418, 1519-1570)

Port of cpp_audio_tpu/apps/resynth.py: every mode runs on --device
(default cuda; --device cpu takes the plain PyTorch versions), and device
outputs come to the host before the WAV is written.
"""

from __future__ import annotations

import argparse
import os

from ..analysis import offline_job, resynth


def _parse_kv(spec: str, allowed: frozenset) -> dict:
    """'a=1,b=0.5' -> {'a': 1.0, 'b': 0.5}; rejects malformed entries and
    unknown keys (a typo would otherwise silently fall back to defaults)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        k = k.strip()
        if not eq or k not in allowed:
            raise ValueError(
                f"bad entry {part!r}: expected key=value with key in "
                f"{sorted(allowed)}")
        try:
            out[k] = float(v)
        except ValueError:
            raise ValueError(f"bad value in {part!r}: not a number")
    return out


_CARRIER_KEYS = frozenset(
    ["noise", "saw", "triangle", "square", "sine", "pulse", "width"])
_VOCODER_VOLUME_KEYS = frozenset(["vocoded", "carrier", "modulator"])


def _run_midi_duplex(live, midi_input, midi_events, signal, block_size):
    """Duplex loop with MIDI playback: before each block, dispatch the MIDI
    events that fall inside it to the carrier synth (the reference's MIDI
    thread publishing into vocoder_carrier, rt.resynth.lib.cpp:1519-1570).
    Returns the (n, 2) output on the host."""
    import numpy as np
    import torch

    signal = np.asarray(signal, np.float64)
    # render past the last MIDI event so held/releasing carrier notes decay
    # through their full envelope release (plus the vocoder's 2-stride lag)
    tail = 0
    if midi_events and live.carrier_synth is not None:
        cfg = live.carrier_synth.config
        tail = int(np.max(np.asarray(cfg.ahdsr.release))) + \
            (2 * live.vocoder.params.stride if live.vocoder is not None
             else 0)
    n_total = max(len(signal),
                  (midi_events[-1].time + 1 + tail) if midi_events else 0)
    parts = []
    ei = 0
    for t0 in range(0, n_total, block_size):
        t1 = min(t0 + block_size, n_total)
        while ei < len(midi_events) and midi_events[ei].time < t1:
            midi_input.dispatch(midi_events[ei])
            ei += 1
        blk = signal[t0:t1]
        if len(blk) < t1 - t0:
            blk = np.concatenate([blk, np.zeros(t1 - t0 - len(blk))])
        live.feed(blk)
        parts.append(live.pull(t1 - t0))
    return torch.cat(parts).cpu().numpy() if parts else np.zeros((0, 2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--job", help="JSON job config path")
    ap.add_argument("--checkpoint", metavar="PATH",
                    help="with --job: resumable render-state snapshots at "
                         "PATH (a killed job restarted with the same flags "
                         "resumes and yields the identical output)")
    ap.add_argument("--checkpoint-seconds", type=float, default=5.0,
                    help="audio seconds between snapshots for --checkpoint")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--deduce", action="store_true",
                    help="note deduction path (reference main.resynth.cpp): "
                         "deduce discrete notes, draw a piano-roll BMP next "
                         "to the output, and re-synthesize them with the "
                         "enveloped-sine pool (include/resynth.hpp)")
    ap.add_argument("--min-db-span", type=float, default=-60.0,
                    help="with --deduce: drop notes more than |span| dB "
                         "below the loudest (main.resynth.cpp:55-70)")
    ap.add_argument("--live", action="store_true",
                    help="stream through the live duplex pipeline")
    ap.add_argument("--block-size", type=int, default=512,
                    help="callback block size for --live")
    ap.add_argument("--midi", metavar="MIDI_FILE",
                    help="with --live: drive the vocoder carrier synth from "
                         "this Standard MIDI File")
    ap.add_argument("--carrier", metavar="SPEC", default="saw=1.0",
                    help="carrier oscillator mix for --midi, e.g. "
                         "'noise=0.1,saw=0.5,triangle=0,square=0,sine=0.2,"
                         "pulse=0.2,width=0.01'")
    ap.add_argument("--vocoder-volumes", metavar="SPEC",
                    default="vocoded=1,carrier=0,modulator=0",
                    help="output mix of the vocoder leg")
    ap.add_argument("--vocode", metavar="CARRIER_WAV",
                    help="vocode the input against this carrier instead of "
                         "resynthesizing")
    ap.add_argument("--vocode-mode", choices=["fft", "filterbank"],
                    default="fft",
                    help="fft = spectral band modulation (the reference's "
                         "active design); filterbank = band-pass + envelope "
                         "follower variant (rt.resynth.lib.vocoder.cpp:"
                         "46-79,560-733)")
    ap.add_argument("--debug-vocoder", metavar="DIR",
                    help="tap every vocoder stage to WAVs in DIR "
                         "(the reference's IMJ_DEBUG_VOCODER)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every mode runs on (cpu: the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = args.device

    if args.job:
        if args.checkpoint:
            from ..analysis import checkpoint
            from ..analysis.presets_json import OfflineJobConfig

            checkpoint.run_job_checkpointed(
                OfflineJobConfig.load(args.job), args.checkpoint,
                segment_seconds=args.checkpoint_seconds, device=dev)
        else:
            offline_job.run_job_file(args.job, device=dev)
        print(f"ran job {args.job}")
        return 0
    if args.checkpoint:
        ap.error("--checkpoint requires --job (only JSON offline jobs "
                 "checkpoint render state)")
    if not args.input or not args.output:
        ap.error("need input and output (or --job)")
    from ..utils import wav as wavio

    if args.live:
        from ..analysis.streaming import LiveResynth

        data, sr = wavio.read_wav(args.input)
        cfg = resynth.ResynthConfig(sample_rate=sr, use_autotune=args.autotune)
        if args.midi:
            from ..analysis.vocoder import VocoderParams
            from ..models.carrier import (CarrierOscMix, CarrierSynth,
                                          CarrierSynthConfig)
            from ..utils.midi_input import MidiInput
            from ..utils.midifile import read_midi_file

            try:
                spec = _parse_kv(args.carrier, _CARRIER_KEYS)
            except ValueError as e:
                ap.error(f"--carrier: {e}")
            osc = CarrierOscMix(
                noise=spec.get("noise", 0.0), saw=spec.get("saw", 0.0),
                triangle=spec.get("triangle", 0.0),
                square=spec.get("square", 0.0), sine=spec.get("sine", 0.0),
                pulse=spec.get("pulse", 0.0),
                pulse_width=spec.get("width", 0.01))
            try:
                vols = _parse_kv(args.vocoder_volumes, _VOCODER_VOLUME_KEYS)
            except ValueError as e:
                ap.error(f"--vocoder-volumes: {e}")
            vp = VocoderParams(sample_rate=sr,
                               volume_vocoded=vols.get("vocoded", 1.0),
                               volume_carrier=vols.get("carrier", 0.0),
                               volume_modulator=vols.get("modulator", 0.0))
            carrier = CarrierSynth(CarrierSynthConfig(sample_rate=sr, osc=osc),
                                   device=dev)
            live = LiveResynth(cfg, vocoder_params=vp, carrier_synth=carrier,
                               device=dev)
            midi_events = sorted(read_midi_file(args.midi, sample_rate=sr),
                                 key=lambda e: e.time)
            mi = MidiInput(lambda: [], carrier, sample_rate=sr)
            out = _run_midi_duplex(live, mi, midi_events, data.mean(axis=1),
                                   args.block_size)
            wavio.write_wav(args.output, out, sr)
            s = live.stats
            print(f"wrote {args.output} (live+midi: {s.windows} windows, "
                  f"on={s.note_on} change={s.note_change} off={s.note_off}, "
                  f"midi events={mi.stats.decoded})")
            return 0
        live = LiveResynth(cfg, device=dev)
        out = live.run_duplex(data.mean(axis=1), block_size=args.block_size)
        wavio.write_wav(args.output, out.cpu().numpy(), sr)
        s = live.stats
        print(f"wrote {args.output} (live: {s.windows} windows, "
              f"on={s.note_on} change={s.note_change} off={s.note_off})")
        return 0

    if args.vocode:
        from ..analysis import vocoder

        mod, sr = wavio.read_wav(args.input)
        car, sr2 = wavio.read_wav(args.vocode)
        if sr2 != sr:
            ap.error("sample rate mismatch between input and carrier")
        fn = (vocoder.vocode_filter_bank if args.vocode_mode == "filterbank"
              else vocoder.vocode)
        out = fn(mod.mean(axis=1), car.mean(axis=1),
                 vocoder.VocoderParams(sample_rate=sr),
                 debug_dir=args.debug_vocoder, device=dev)
        wavio.write_wav(args.output, out, sr)
        print(f"wrote {args.output} (vocoded)")
        return 0

    if args.deduce:
        from ..analysis import notes as notes_mod

        data, sr = wavio.read_wav(args.input)
        cfg = resynth.ResynthConfig(sample_rate=sr)
        deduced = notes_mod.deduce_notes(data.mean(axis=1), sr,
                                         min_db_span=args.min_db_span,
                                         config=cfg, device=dev)
        bmp = os.path.splitext(args.output)[0] + ".notes.bmp"
        notes_mod.write_bmp(bmp, notes_mod.notes_image(deduced))
        out = notes_mod.resynth_deduced(deduced, sample_rate=sr,
                                        stride=cfg.stride, device=dev)
        wavio.write_wav(args.output, out.cpu().numpy(), sr)
        print(f"wrote {args.output} + {bmp} ({len(deduced)} notes)")
        return 0

    cfg = resynth.ResynthConfig(use_autotune=args.autotune)
    resynth.resynth_wav(args.input, args.output, cfg, device=dev)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
