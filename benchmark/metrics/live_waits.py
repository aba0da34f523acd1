"""live_waits.live: the mean count per callback of the live path's waits for
the device: the change of the program's span counter "live_waits" (each
host array the path uploads and each device array it reads back) over the
callback's `duplex` span; the spans of the traced run's profiled stretch.
None without a duplex span or where the program keeps no such counter."""

from benchmark.harness.spans import summary


def read(run, name):
    return summary().get("duplex", {}).get("live_waits")
