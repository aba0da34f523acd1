"""The voice-bank kernel's least time (harness/counts.py: the profiled jobs'
live voice-samples at the published H100 peaks) over its device time in
the profiler's trace, in percent."""


def read(run, name):
    t = sum(v for k, v in run.trace.get("kernel_s", {}).items() if "voicebank_kernel" in k)
    return 100.0 * run.bound_s / t if t > 0 else None
