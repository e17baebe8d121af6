"""tools/spmm_probe.py at a tiny size on the CPU."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_spmm_probe_small(capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import spmm_probe

    spmm_probe.main(["--small", "--parts", "spmm,dense"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [p["part"] for p in lines] == ["spmm", "dense"]
    for key in ("gather_fwd_d256_ms", "bf16_operands_t_d40_ms"):
        assert lines[0][key] > 0
    assert any(k.endswith("_dense_fwdbwd_ms") for k in lines[1])
    assert any(k.endswith("_gather_fwdbwd_ms") for k in lines[1])
