"""The port's observability helpers (xmhw_tpu_torch.utils): timed() and
trace(), the counterparts of xmhw_tpu.utils. Their CUDA side (timed()
synchronising the card) is tested in tests/test_torch_cuda.py."""

import json
import logging

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xmhw_tpu_torch import utils  # noqa: E402


def test_timed_measures_and_leaves_cpu_tensors_alone(monkeypatch, caplog):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    with caplog.at_level(logging.INFO, logger="xmhw_tpu_torch"):
        with utils.timed("sum", sync=torch.ones(3)) as t:
            t["sync"] = {"a": [torch.zeros(2), (torch.ones(1), 3)]}
    assert t["seconds"] >= 0.0
    assert calls == []  # nothing on a CUDA device: no synchronisation
    assert "sum:" in caplog.text
    with utils.timed("quiet", log=False) as t:
        pass
    assert t["seconds"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with utils.trace(str(tmp_path / "tr")) as prof:
        (torch.arange(1000.0) * 2).sum()
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
