"""render_launches.<job|clips|serve>: the mean count per job (per batch in
the batched cell) of tracked-note render kernel launches inside the
program's `render` span: the change of the span counter "render_launches"
(cpp_audio_tpu_torch.ops.cuda_render.LAUNCHES); the spans of the traced
run's profiled stretch. None without a render span or where the program
keeps no such counter."""

from benchmark.harness.spans import summary


def read(run, name):
    return summary().get("render", {}).get("render_launches")
