"""The share of the traced jobs' own time in which no kernel,
copy or set ran on the device: the union of their intervals in the
profiler's trace, within the benchmark's "job" ranges."""


def read(run, name):
    t = run.trace
    return 100.0 * (1.0 - t["busy_in_jobs_s"] / t["jobs_s"]) if t.get("jobs_s") else None
