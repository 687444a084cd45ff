"""The profiler's reading: busy time, idle gaps by host span, the
breakdown, and the completeness of the kernels' events."""

import json
import re

import pytest

from pbcore import trace


def _trace(tmp_path, device, host):
    events = [{"ph": "X", "cat": "user_annotation", "name": "pb.window", "ts": 0, "dur": 100,
               "tid": 1}]
    events += [{"ph": "X", "cat": c, "name": n, "ts": s, "dur": d} for n, s, d, c in device]
    events += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": s, "dur": d, "tid": 1}
               for n, s, d in host]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return trace.read_chrome_trace(str(p))


def test_busy_gaps_and_breakdown(tmp_path):
    r = _trace(tmp_path,
               [("void flash_fwd_bf16<128>(CUtensorMap)", 10, 20, "kernel"),
                ("void flash_fwd_bf16<128>(CUtensorMap)", 25, 10, "kernel"),   # overlaps
                ("Memcpy DtoH", 60, 10, "gpu_memcpy"),
                ("late", 95, 20, "kernel")],                                    # clipped at 100
               [("aten::mm", 0, 12), ("predict", 30, 40), ("aten::copy_", 40, 15)])
    assert abs(r.window_s - 100e-6) < 1e-12
    assert abs(r.busy_s - (25 + 10 + 5) * 1e-6) < 1e-12
    assert r.gaps() == [(0, 10), (35, 60), (70, 95)]
    b = r.breakdown()
    assert b["device_ops"][0][0] == "flash_fwd_bf16<128>"
    assert b["device_ops"][0][1] == pytest.approx(30e-6)
    gaps = dict(b["idle_gaps"])
    assert gaps == pytest.approx({"aten::mm": 10e-6, "aten::copy_": 25e-6, "host idle": 25e-6})


def test_completeness(tmp_path):
    specs = {"flash_fwd": {"count": "x", "count_re": re.compile(r"\bflash_fwd_bf16\b"),
                           "time_re": re.compile(r"\bflash_fwd_bf16\b"),
                           "per_launch": 1}}
    r = _trace(tmp_path, [("void flash_fwd_bf16<128>(a)", 1, 2, "kernel"),
                          ("void flash_fwd_1pass_bf16<64>(a)", 4, 2, "kernel")], [])
    assert trace.check_complete(r, {"flash_fwd": 1}, specs) == []
    assert trace.check_complete(r, {"flash_fwd": 2}, specs)
    assert abs(r.kernel_time_s(specs["flash_fwd"]) - 2e-6) < 1e-12


def test_kernel_specs_parse():
    specs = trace.kernel_specs()
    assert {"flash_fwd", "flash_fwd_1pass", "relpos_fwd", "relpos_window",
            "factored_decode"} <= set(specs)
    assert specs["flash_fwd"]["count_re"].search("void flash_fwd_bf16<128>(CUtensorMap)")
    assert not specs["flash_fwd"]["count_re"].search("void flash_fwd_1pass_bf16<64>(x)")
    assert specs["flash_fwd_1pass"]["time_re"].search("void key_norm_max2<__nv_bfloat16>(x)")
