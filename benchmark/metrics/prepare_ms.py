"""Staging of a batch (prepare_offline_chain_device_batch: the voice
tables, carrier and tracker inputs to the device), host clock between two
synchronisations, mean per batch over the traced run's timed batches."""


def read(run, name):
    xs = run.prepare_s
    return sum(xs) / len(xs) * 1e3 if xs else None
