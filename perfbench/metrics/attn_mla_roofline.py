"""The decoder's latent attention (kernel A at q/k head dim 192 and v 128,
one launch a layer): its bound from the shapes (``counts_mla_moe``: q and k
at 192, v and o at 128, each read or written once; the causal pairs'
products) over the device time of kernel A's launches."""


def read(ctx):
    from pbcore import counts_mla_moe as M
    from pbcore.readers import roofline
    rows, T = M.shape(ctx.cfg, ctx.traffic)
    per_launch, _ = M.mla_attention_bound(ctx.cfg, rows, T)
    return roofline(ctx, [("flash_fwd", per_launch, ctx.cfg["num_hidden_layers"])])
