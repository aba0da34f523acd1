"""host_waits.<job|clips|serve>: the mean count per job (per batch in the
batched cell) of the host's waits for the device inside the chain's stage
spans: the change of device_tracker.HOST_SYNCS + H2D_COPIES (the tracker's
flag reads, the host arrays copied to the device) over each stage span,
summed over the five stages; the spans of the traced run's profiled
stretch. None without such spans."""

from benchmark.harness.spans import summary

STAGES = ("synth", "analysis", "vocoder", "tracker", "render")


def read(run, name):
    spans = summary()
    if not all(s in spans and "host_waits" in spans[s] for s in STAGES):
        return None
    return sum(spans[s]["host_waits"] for s in STAGES)
