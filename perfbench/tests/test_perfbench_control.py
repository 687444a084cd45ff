"""The control at the cells' own size, on the card: the reference computed
in fp8 in the program's place must fail at least one of the cell's
limits on every seed.  Skips without a card (the CPU counterpart, at the
tiny size, is ``test_perfbench_entries.test_control_reads_far_above_the_program``)."""

import pytest

from pbcore import manifest

CELLS = ("llmseg_mistral7b.predict_b4", "sam_vit_h.amg_k50")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_at_full_size(name, cuda):
    import torch
    cell = manifest.load(name)
    for seed in (2147483711, 2147483713, 2147483717):
        e = cell.entry().Entry(cell.config, cell.traffic, seed, "cuda")
        e.setup()
        e.window(0.0, max_steps=2)
        e.release()
        got = e.control("fp8")
        assert any(got[k] > lim for k, lim in cell.work["check"].items()), (seed, got)
        del e
        torch.cuda.empty_cache()
