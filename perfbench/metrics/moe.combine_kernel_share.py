"""The share of the MoE blocks whose combine went through the program's
hand-written kernel: the program's counter ``moe.combine_kernels`` over
the blocks run (``moe.grouped_gemms``, two a block).  1.0 where every
block's combine is the kernel; None where the program counted none (the
CPU, or a program without the kernel)."""


def read(ctx):
    from pbcore.spans import counter
    combines, gemms = counter("moe.combine_kernels"), counter("moe.grouped_gemms")
    return combines / (gemms / 2) if combines and gemms else None
