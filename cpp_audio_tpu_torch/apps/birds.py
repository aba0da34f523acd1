"""The `birds` app: render procedural SoundEngine programs
(reference source/main.birds.cpp).

One-shot render:
    python -m cpp_audio_tpu_torch.apps.birds --mode birds --program 0 --seconds 5 out.wav
Interactive stdin loop (the reference's CLI shape, main.birds.cpp:107-187 —
enter a number to change program, any other word to replay with a fresh
random realization, 'q' to quit; each note renders to a numbered WAV under
--out-dir since this environment has no audio device):
    python -m cpp_audio_tpu_torch.apps.birds --interactive --out-dir /tmp/birds

Port of cpp_audio_tpu/apps/birds.py: every mode renders on --device
(default cuda), the master limiter included, and each render is copied to
the host once, for its WAV.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from ..models import soundengine, voice_presets, wind
from ..utils import wav as wavio


def render(mode: str, program, seconds: float, *, freq: float = 440.0,
           sample_rate: int = 44100, seed: int = 1, device="cuda") -> torch.Tensor:
    """Render a program through the master post chain (limiter + clamp/NaN
    guard, reference outputDataBase::postprocess out.h:605-648) — some wind
    presets (rapidly width-modulated compensated band-passes, e.g. 'Small
    animal eating') rely on the master limiter for sane output levels.
    Returns an (n, 2) tensor on `device`; whether the limiter runs is one
    read of the render's peak."""
    from ..ops import limiter as lim

    m = voice_presets.Mode(mode)
    prog = voice_presets.get_program(m, program)
    n = int(seconds * sample_rate)
    if m is voice_presets.Mode.WIND:
        out = wind.render_program(prog, n, sample_rate, seed=seed, device=device)
    else:
        out = soundengine.render_program(prog, freq, n, sample_rate, seed=seed,
                                         device=device)
    if float(out.abs().max()) > 1.0:
        out = lim.clamp_and_guard(lim.limit(out, ceiling=1.0, sample_rate=sample_rate))
    return out


def list_programs() -> str:
    lines = []
    for mode, progs in voice_presets.PROGRAMS.items():
        lines.append(f"{mode.value}:")
        for i, p in enumerate(progs):
            lines.append(f"  {i}: {p.name}")
    return "\n".join(lines)


def interactive(*, mode: str = "robots", program: int = 0,
                seconds: float = 3.0, freq: float = 200.0,
                sample_rate: int = 44100, seed: int = 1,
                out_dir="birds_session", stdin=None, stdout=None,
                device="cuda") -> int:
    """The reference's interactive stdin loop (main.birds.cpp:107-187).

    Per iteration: a note plays (here: renders to out_dir/note_NNN.wav), then
    the prompt reads one token — a program number switches program (noteOff +
    useProgram + noteOn, main.birds.cpp:125-141), any other word replays the
    current program with a fresh random seed, 'q' quits. Returns the number
    of notes played.
    """
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    m = voice_presets.Mode(mode)
    progs = voice_presets.PROGRAMS[m]
    program = min(program, len(progs) - 1)
    print(f"using program '{progs[program].name}'", file=stdout)

    note_idx = 0

    def play():
        nonlocal note_idx
        note_idx += 1
        out = render(m.value, program, seconds, freq=freq,
                     sample_rate=sample_rate, seed=seed, device=device)
        path = out_dir / f"note_{note_idx:03d}.wav"
        wavio.write_wav(path, out.cpu().numpy(), sample_rate)
        print(f"note {note_idx}: pitch {freq} program "
              f"'{progs[program].name}' seed {seed} -> {path}", file=stdout)

    play()
    while True:
        print("enter number to change program, or letter to play note, "
              "or 'q' to quit:", file=stdout)
        line = stdin.readline()
        if not line:
            break
        tok = line.strip()
        if not tok:
            continue
        print(f"pressed:{tok}", file=stdout)
        if tok == "q":
            print("quitting", file=stdout)
            break
        try:
            n = int(tok)
            if 0 <= n < len(progs):
                program = n
                print(f"using program '{progs[program].name}'", file=stdout)
        except ValueError:
            print("not a number", file=stdout)
        # replay with a fresh random realization (the reference's SoundEngine
        # reruns its markov chain each noteOn; seeded here for replayability)
        seed += 1
        play()
    return note_idx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", nargs="?", default="birds.wav")
    ap.add_argument("--mode", default="birds",
                    choices=[m.value for m in voice_presets.Mode])
    ap.add_argument("--program", default="0")
    ap.add_argument("--freq", type=float, default=440.0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--sample-rate", type=int, default=44100)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--list", action="store_true", help="list programs and exit")
    ap.add_argument("--interactive", action="store_true",
                    help="stdin loop: number = program change, other = "
                         "replay, q = quit (main.birds.cpp:107-187)")
    ap.add_argument("--out-dir", default="birds_session",
                    help="where --interactive writes its note WAVs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)

    if args.list:
        print(list_programs())
        return 0

    if args.interactive:
        interactive(mode=args.mode,
                    program=int(args.program) if args.program.isdigit() else 0,
                    seconds=args.seconds, freq=args.freq,
                    sample_rate=args.sample_rate, seed=args.seed,
                    out_dir=args.out_dir, device=args.device)
        return 0

    program = int(args.program) if args.program.isdigit() else args.program
    progs = voice_presets.PROGRAMS[voice_presets.Mode(args.mode)]
    if isinstance(program, int) and not (0 <= program < len(progs)):
        ap.error(f"program index {program} out of range (mode {args.mode} has "
                 f"{len(progs)} programs; use --list)")
    out = render(args.mode, program, args.seconds, freq=args.freq,
                 sample_rate=args.sample_rate, seed=args.seed, device=args.device)
    wavio.write_wav(args.output, out.cpu().numpy(), args.sample_rate)
    print(f"wrote {args.output} ({args.seconds}s, mode={args.mode})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
