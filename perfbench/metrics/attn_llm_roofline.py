"""The decoder's causal attention (kernel A, one launch a layer): its bound
from the shapes (q and o at the query heads, k and v at the key-value
heads, each read or written once; the causal pairs' products) over the
device time of kernel A's launches."""


def read(ctx):
    from pbcore.readers import roofline
    c, L, t = ctx.counts, ctx.cfg["llm"], ctx.traffic
    rows = t["images_per_batch"] * t["rows_per_image"]
    v = ctx.cfg["vision"]
    T = t["text_len"] - 1 + (v["image_size"] // v["patch_size"]) ** 2
    flops = rows * c.attention_flops(c.causal_pairs(T, T), L["num_attention_heads"], L["head_dim"])
    per_launch, _ = c.bound(c.llm_attention_bytes(L, rows, T), flops)
    return roofline(ctx, [("flash_fwd", per_launch, L["num_hidden_layers"])])
