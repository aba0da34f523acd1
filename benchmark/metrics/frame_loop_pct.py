"""The share of the window's jobs whose slot table the device tracker built in
its exact frame loop (device_tracker.FRAME_LOOPS), in percent."""


def read(run, name):
    return 100.0 * run.frame_loops / len(run.jobs) if run.jobs else None
