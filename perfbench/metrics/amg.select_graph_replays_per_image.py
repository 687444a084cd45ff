"""Replays of AMG's selection (the decode's chunks and the filters, up to
the NMS) as a CUDA graph an image (the program's counter
``amg.select_graph_replays``): 1 where every image replays a graph
captured in the warm-up; None where the program counted none (the CPU, or
a program that selects eagerly)."""


def read(ctx):
    from pbcore.spans import counter
    n = counter("amg.select_graph_replays")
    return n / ctx.steps if n else None
