"""stage_gpu_ms.<stage>[.clips|.serve]: the mean device ms per job (per
batch in the batched cell) of the program's span <stage> ("synth",
"analysis", "vocoder", "tracker" or "render"), from the pair of CUDA events
the span records on the stream without synchronising; the spans of the
traced run's profiled stretch (cpp_audio_tpu_torch.utils.profiling.SPANS).
None without such spans or without device times."""

from benchmark.harness import spans


def read(run, name):
    entry = spans.summary().get(name.split(".")[1])
    return entry["device_ms"] if entry else None
