"""The program's stage spans (cpp_audio_tpu_torch.utils.profiling.SPANS):
in a traced run they hold exactly the profiled stretch, since set-up runs
no profiler and the check runs only the reference."""


def summary() -> dict:
    """The spans' summary by name ({} where the program keeps none)."""
    try:
        from cpp_audio_tpu_torch.utils import profiling
    except ImportError:
        return {}
    store = getattr(profiling, "SPANS", None)
    return store.summary()["spans"] if store is not None else {}
