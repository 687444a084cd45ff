"""The mask decoder on a chunk of grid prompts (kernel G, one call a
chunk): the bound of the decoder's math from its shapes
(``counts.twoway_flops``, the shared image embedding read once, the masks
written once) over the device time of every kernel G runs."""


def read(ctx):
    from pbcore.readers import roofline
    c, amg = ctx.counts, ctx.traffic["amg"]
    P, N, L = c.decode_call_shape(ctx.cfg, amg)
    per_call, _ = c.bound(c.decode_bytes(ctx.cfg, amg),
                          c.twoway_flops(ctx.cfg["decoder"], P, N, L, True, True))
    calls = -(-amg["points_per_side"] ** 2 // P)
    return roofline(ctx, [("factored_decode", per_call, calls)])
