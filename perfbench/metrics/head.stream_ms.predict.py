"""Stream ms a predict call of the program's span ``llmseg.head``
(``models/llmseg.forward``: the ``[SEG]`` gather, ``project_text`` and the selection head): CUDA events on the stream
at the stage's start and end.  Idle included: where the host launches the
stage more slowly than the card runs it, as under the profiler, this is
the host's pace and not the stage's kernels' time."""


def read(ctx):
    from pbcore.spans import span_ms
    return span_ms(ctx, ["llmseg.head"], "stream_ms")
