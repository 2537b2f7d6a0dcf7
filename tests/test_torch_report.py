"""``repro_torch.analysis.report`` against ``repro/analysis/report.py``:
on the same cost numbers and the v5e specs, ``analyze_cell`` gives the
reference's row exactly.  The reference reads its numbers from an HLO
file (its parser is stood in for here); the port from the cell's
``step_cost``.  The adjusted memory term drops the reference's
convert-only fusions and the port's dtype casts (``_to_copy``), given the
same bytes here.  Then ``build_report`` over cells the dry-run CLI wrote,
against the H100 specs."""

import json

import pytest
import torch

from repro.analysis import hlo as jhlo
from repro.analysis import report as jreport
from repro_torch.analysis import report
from repro_torch.analysis.cost import StepCost
from repro_torch.analysis.roofline import H100_SPECS, TPU_V5E_SPECS
from repro_torch.launch import dryrun

torch.set_num_threads(1)

CELLS = [("smollm-360m", "train_4k"), ("smollm-360m", "decode_32k"),
         ("qwen2-72b", "prefill_32k"), ("olmoe-1b-7b", "train_4k"),
         ("deepseek-v3-671b", "decode_32k"), ("llama-3.2-vision-90b", "train_4k")]
COSTS = [(4.2e15, 1.2e14, 3.0e13, {}), (3.1e10, 7.4e11, 0.0, {}),
         (9.0e16, 2.0e13, 5.0e12, {"all-gather": 4.0e11, "all-reduce": 1.0e9}),
         (0.0, 5.0e9, 1.0e9, {})]


def _rec(arch, shape, devices=1):
    return {"arch": arch, "shape": shape, "mesh": "1gpu", "variant": "lrd",
            "devices": devices, "status": "ok",
            "memory_per_device": {"argument_bytes": 3 << 30, "temp_bytes": 5 << 29}}


@pytest.mark.parametrize("flops,nbytes,casts,coll", COSTS)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_analyze_cell_equals_the_references(arch, shape, flops, nbytes, casts, coll,
                                            monkeypatch):
    jcost = jhlo.HloCost(flops=flops, bytes=nbytes, collective_bytes=dict(coll),
                         bytes_by_op={"convert-only-fusion": casts, "dot": nbytes - casts})
    monkeypatch.setattr(jreport, "analyze_hlo", lambda text: jcost)
    want = jreport.analyze_cell(_rec(arch, shape, devices=4), "HloModule stand-in")
    rec = dict(_rec(arch, shape, devices=4), step_cost=StepCost(
        flops=flops, bytes=nbytes, collective_bytes=dict(coll),
        bytes_by_op={"_to_copy": casts, "mm": nbytes - casts},
        flops_by_dtype={"bfloat16": flops} if flops else {}).to_json())
    got = report.analyze_cell(rec, specs=TPU_V5E_SPECS)
    assert got == want


def test_report_over_dry_run_cells(tmp_path, capsys):
    for argv in (["--shape", "decode_32k"], ["--shape", "decode_32k", "--dense"]):
        dryrun.main(["--arch", "smollm-360m", "--out", str(tmp_path)] + argv)
    (tmp_path / "x__train_4k__1gpu__lrd.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "status": "fail"}))
    rows = report.main(["--dir", str(tmp_path), "--json", str(tmp_path / "r" / "rows.json")])
    out = capsys.readouterr().out
    assert len(rows) == 2 and "2 cells analyzed (h100-sxm)" in out
    assert json.loads((tmp_path / "r" / "rows.json").read_text()) == rows
    dense, lrd = sorted(rows, key=lambda r: r["variant"])
    assert (lrd["variant"], dense["variant"]) == ("lrd", "dense")
    # a decode step reads every weight and the whole cache: memory-bound
    for r in rows:
        assert r["dominant"] == "memory" and r["step_lower_bound_s"] == r["memory_s"] > 0
        assert 0 < r["memory_adj_s"] <= r["memory_s"]
    # the low-rank factors take fewer FLOPs than the dense weights
    assert lrd["hlo_flops_per_dev"] < dense["hlo_flops_per_dev"]
    assert report.to_markdown(rows).count("\n| smollm-360m | decode_32k |") == 2
    assert H100_SPECS.name == "h100-sxm"
