"""The port's roofline (``repro_torch.roofline.analysis``) against the
reference's (``repro.roofline.analysis``): ``model_flops_for`` on every
cell, ``Roofline``'s terms on the same inputs and constants, the ring
wire-byte model against ``_line_collective`` on synthetic HLO lines, and
``StepCounter``'s FLOP, byte and alias rules on local operations."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.registry import cells as ref_cells
from repro.configs.registry import get_config as ref_config
from repro.roofline import analysis as ref
from repro_torch.configs.registry import cells, get_config
from repro_torch.roofline import analysis

pytestmark = pytest.mark.tier1


def test_model_flops_match_on_every_cell():
    assert cells(include_skipped=True) == ref_cells(include_skipped=True)
    for arch, shape, _ok in cells(include_skipped=True):
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert cfg.active_param_count() == rcfg.active_param_count()
        assert cfg.param_count() == rcfg.param_count()
        n = cfg.active_param_count()
        assert analysis.model_flops_for(cfg, shape, n) == \
            ref.model_flops_for(rcfg, shape, n), (arch, shape)


INPUTS = [
    dict(arch="a", shape="train_4k", mesh="single", chips=256,
         flops_per_dev=3.1e14, bytes_per_dev=2.2e12,
         wire_bytes_per_dev=4.5e10, model_flops=6e16),
    dict(arch="b", shape="decode_32k", mesh="multi", chips=512,
         flops_per_dev=2.0e9, bytes_per_dev=9.0e10,
         wire_bytes_per_dev=1.0e11, model_flops=3e12),
    dict(arch="c", shape="prefill_32k", mesh="single", chips=256,
         flops_per_dev=0.0, bytes_per_dev=0.0, wire_bytes_per_dev=0.0,
         model_flops=0.0),
]


@pytest.mark.parametrize("inputs", INPUTS, ids=lambda d: d["arch"])
def test_roofline_terms_match_at_the_same_constants(monkeypatch, inputs):
    monkeypatch.setattr(analysis, "PEAK_FLOPS", ref.PEAK_FLOPS)
    monkeypatch.setattr(analysis, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(analysis, "LINK_BW", ref.ICI_BW)
    want = ref.Roofline(**inputs, peak_flops=ref.PEAK_FLOPS).finalize()
    got = analysis.Roofline(**inputs, peak_flops=ref.PEAK_FLOPS).finalize()
    assert got.to_dict() == want.to_dict()
    assert got.step_time_est == want.step_time_est and got.mfu == want.mfu


def test_h100_constants():
    r = analysis.Roofline(arch="a", shape="train_4k", mesh="single",
                          chips=1, flops_per_dev=989e12,
                          bytes_per_dev=3.35e12, wire_bytes_per_dev=450e9,
                          model_flops=989e12).finalize()
    assert r.t_compute == r.t_memory == r.t_collective == 1.0
    assert r.mfu == 1.0 and r.peak_flops == 989e12


_DT = {"bf16": 2, "f32": 4, "s32": 4, "u8": 1}


def _lines():
    """(HLO line, op, output bytes, group size) of every collective kind,
    with both replica-group spellings, tuple outputs and async starts."""
    out = []
    for op in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for dt, dims in (("bf16", (16, 1024)), ("f32", (8, 4096, 32)),
                         ("s32", (7,))):
            nbytes = int(np.prod(dims)) * _DT[dt]
            shape = f"{dt}[{','.join(map(str, dims))}]{{0}}"
            for groups, g in (("replica_groups=[16,16]<=[256]", 16),
                              ("replica_groups=[2,4]<=[8]", 4),
                              ("replica_groups={{0,1},{2,3}}", 2)):
                out.append((f"  %x.1 = {shape} {op}(%p.0), channel_id=1, "
                            f"{groups}, dimensions={{0}}", op, nbytes, g))
            out.append((f"  %s.2 = {shape} {op}-start(%p.0), "
                        f"replica_groups=[4,2]<=[8]", op, nbytes, 2))
            tup = f"({shape}, {shape})"
            out.append((f"  %t.3 = {tup} {op}(%p.0, %p.1), "
                        f"replica_groups=[8,32]<=[256]", op, 2 * nbytes, 32))
    return out


def test_wire_model_matches_line_collective():
    lines = _lines()
    assert len(lines) == 75
    for line, op, nbytes, g in lines:
        want = ref._line_collective(line)
        assert want is not None and want[0] == op, line
        wire, in_b = analysis.wire_bytes(op, nbytes, g)
        assert (op, wire, in_b) == want, line
    assert ref._line_collective("  %d = bf16[4]{0} all-gather-done(%s)") \
        is None


def test_step_counter_counts_local_ops():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    with analysis.StepCounter() as c:
        y = a @ b                       # 2 * 64 * 32 * 16 FLOPs, 4 KB out
        y.add_(1.0)                     # in place: no bytes
        v = y.view(16, 64)              # a view: no bytes
        z = v.sum()                     # 4 bytes
    assert c.stats.flops == 2 * 64 * 32 * 16
    assert c.stats.hbm_bytes == 64 * 16 * 4 + 4
    assert c.stats.count == 0 and c.stats.wire_bytes == 0
    assert float(z) == pytest.approx(float((a @ b + 1).sum()), rel=1e-5)


def test_collective_stats_accumulate():
    st = analysis.CollectiveStats()
    st.add_collective("all-gather", 1024, 16)
    st.add_collective("all-reduce", 512, 4)
    st.add_collective("reduce-scatter", 256, 4)
    assert st.count == 3
    assert st.wire_bytes == 1024 + 2 * 512 + 3 * 256
    assert st.operand_bytes == 64 + 512 + 1024
    assert st.by_op["all-reduce"] == {"count": 1, "wire_bytes": 1024}
    assert dataclasses.asdict(st)["by_op"]["all-gather"]["count"] == 1
