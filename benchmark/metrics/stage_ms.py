"""stage_ms.<stage>: stage <stage> ("synth", "analysis", "tracker",
"render" or "vocoder") of the device chain's timings= (the device
synchronised after each stage), its mean per job over the traced run's
timed jobs."""


def read(run, name):
    xs = run.stage_s.get(name.split(".")[1])
    return sum(xs) / len(xs) * 1e3 if xs else None
