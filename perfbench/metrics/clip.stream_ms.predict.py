"""Stream ms a predict call of the program's span ``llmseg.clip``
(``models/llmseg.forward``: CLIP and the projector): CUDA events on the stream
at the stage's start and end.  Idle included: where the host launches the
stage more slowly than the card runs it, as under the profiler, this is
the host's pace and not the stage's kernels' time."""


def read(ctx):
    from pbcore.spans import span_ms
    return span_ms(ctx, ["llmseg.clip"], "stream_ms")
