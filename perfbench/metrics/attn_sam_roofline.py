"""The image encoder's attention with its relative-position bias: kernel E
(global blocks, the whole grid) and F (windowed blocks, the zero-padded
windows), each launch's bound from the shapes (q, k, v, o and the two bias
tables read or written once; the products) over their device time."""


def read(ctx):
    from pbcore.readers import roofline
    c, e = ctx.counts, ctx.cfg["encoder"]
    g, ws, H = e["image_size"] // e["patch_size"], e["window_size"], e["num_heads"]
    hd = e["embed_dim"] // H
    n_win = (-(-g // ws)) ** 2

    def per_launch(bh, side):
        T = side * side
        return c.bound(c.BF16 * bh * T * (4 * hd + 2 * side), c.attention_flops(T * T, bh, hd))[0]

    n_global = len(e["global_attn_indexes"])
    return roofline(ctx, [("relpos_fwd", per_launch(H, g), n_global),
                          ("relpos_window", per_launch(n_win * H, ws), e["depth"] - n_global)])
