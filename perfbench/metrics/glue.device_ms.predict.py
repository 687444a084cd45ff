"""Device ms a predict step of every kernel that is neither a product
(cuBLAS, CUTLASS) nor one of the program's own: norms, activations,
casts, copies, reductions, the splice, RoPE, the k/v repeat."""


def read(ctx):
    from pbcore.readers import glue_ms
    return glue_ms(ctx)
