"""The routed experts' grouped products (``torch._grouped_mm``, two a MoE
layer): their bound from the shapes (``counts_mla_moe.routed_experts_bound``:
each expert's weights read once, the gathered pairs' operands and outputs,
every pair's products) over the device time of the grouped GEMM kernels,
found by name.  None unless the profile holds as many of them as the
program's counter ``moe.grouped_gemms`` counted."""

import re

GROUPED = re.compile(r"GroupProblemShape|grouped_mm|GroupedGemm", re.I)


def read(ctx):
    from pbcore import counts_mla_moe as M
    from pbcore.spans import counter
    n = counter("moe.grouped_gemms")
    events = [e for e in ctx.reading.device if e[3] == "kernel" and GROUPED.search(e[0])]
    if not n or len(events) != n:
        return None
    rows, T = M.shape(ctx.cfg, ctx.traffic)
    per_layer, _ = M.routed_experts_bound(ctx.cfg, rows, T)
    time_s = sum(e[2] for e in events) * 1e-6
    return 100.0 * per_layer * (n / 2) / time_s
