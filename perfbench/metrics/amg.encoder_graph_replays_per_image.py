"""Replays of SAM's image encoder as a CUDA graph an image (the program's
counter ``sam.encoder_graph_replays``): 1 where every image replays a graph
captured in the warm-up; None where the program counted none (the CPU, or a
program that runs the encoder eagerly)."""


def read(ctx):
    from pbcore.spans import counter
    n = counter("sam.encoder_graph_replays")
    return n / ctx.steps if n else None
