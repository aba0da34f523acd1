"""host_ms.<span>[.clips|.serve]: the mean host ms per job (per batch in
the batched cell) of the program's span <span> ("tracker": its dispatch and
its wait for the violation flag; "staging": the step's arguments to the
device), perf_counter_ns at the span's entry and exit; the spans of the
traced run's profiled stretch. None without such spans."""

from benchmark.harness import spans


def read(run, name):
    entry = spans.summary().get(name.split(".")[1])
    return entry["host_ms"] if entry else None
