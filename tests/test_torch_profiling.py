"""The port's profiling surface (``utils/profiling.py``): the host
profilers copied from the JAX package, held against its functions' shapes,
and ``DeviceTracer`` on ``torch.profiler`` (CPU activity here; the card's
sessions are held in ``tests/test_torch_gpu.py``)."""
import json
import os
import threading
import tracemalloc

import jax  # noqa: F401  (kept like the other port tests)
import pytest
import torch

from nomad_tpu.utils import profiling as jprof
from nomad_tpu_torch.utils import profiling as pprof


def trace_events(info):
    with open(os.path.join(info["dir"], pprof.DeviceTracer.TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_tracer_records_a_torch_computation(tmp_path):
    tracer = pprof.DeviceTracer(base_dir=str(tmp_path), device="cpu")
    d = tracer.start()
    assert d.startswith(str(tmp_path)) and os.path.isdir(d)
    x = torch.randn(32, 32, generator=torch.Generator().manual_seed(3))
    (x @ x).relu().sum()
    info = tracer.stop()
    assert set(info) == {"dir", "duration_s"} and info["dir"] == d
    assert info["duration_s"] >= 0
    names = {e.get("name") for e in trace_events(info)}
    assert {"aten::mm", "aten::relu", "aten::sum"} <= names


def test_one_active_session(tmp_path):
    tracer = pprof.DeviceTracer(base_dir=str(tmp_path), device="cpu")
    d = tracer.start()
    with pytest.raises(RuntimeError, match="already active"):
        tracer.start()
    tracer.stop()
    # The next session starts once the first has stopped.
    tracer.start()
    assert os.path.isdir(tracer.stop()["dir"])
    assert os.path.isdir(d)


def test_stop_without_session_raises(tmp_path):
    tracer = pprof.DeviceTracer(base_dir=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="no active trace"):
        tracer.stop()


def test_capture_is_bounded(tmp_path):
    tracer = pprof.DeviceTracer(base_dir=str(tmp_path), device="cpu")
    info = tracer.capture(0.01)          # raised to the 0.05 s floor
    assert info["duration_s"] >= 0.05
    assert os.path.isfile(os.path.join(info["dir"],
                                       pprof.DeviceTracer.TRACE_FILE))


def test_default_device_is_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pprof.DeviceTracer(base_dir=str(tmp_path))
    tracer = pprof.DeviceTracer(device="cpu")
    assert tracer.base_dir.endswith("nomad_tpu_torch_traces")


def test_get_tracer_is_one_per_process(monkeypatch):
    monkeypatch.setattr(pprof, "_tracer", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pprof.get_tracer()
    # With a card (faked: the tracer is only made, not started), every
    # caller gets the same tracer, from any thread.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    got = []
    threads = [threading.Thread(target=lambda: got.append(pprof.get_tracer()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(got) == 8 and all(t is got[0] for t in got)
    assert got[0] is pprof.get_tracer()
    assert got[0].device.type == "cuda"


def test_cpu_profile_matches_reference_shape():
    stop = threading.Event()
    worker = threading.Thread(target=stop.wait, name="sleeper")
    worker.start()
    try:
        port = pprof.cpu_profile(0.1, top=5)
        ref = jprof.cpu_profile(0.1, top=5)
    finally:
        stop.set()
        worker.join(timeout=10)
    for text in (port, ref):
        head, table = text.split("\n\n", 1)
        assert "samples over 0.10s" in head
        assert table.splitlines()[0].split() == ["incl", "leaf", "function"]
        assert 1 <= len(table.splitlines()) <= 6
    assert "wait" in port


def test_heap_profile_matches_reference_shape(monkeypatch):
    was_tracing = tracemalloc.is_tracing()
    monkeypatch.setattr(pprof, "_heap_started", False)
    monkeypatch.setattr(jprof, "_heap_started", False)
    try:
        assert pprof.heap_profile() == jprof.heap_profile() == {
            "status": "tracer started; re-request for data"}
        blob = [bytearray(1024) for _ in range(100)]
        port, ref = pprof.heap_profile(top=3), jprof.heap_profile(top=3)
        assert set(port) == set(ref) == {"current_bytes", "peak_bytes", "top"}
        assert 1 <= len(port["top"]) <= 3
        assert any(__file__ in site["site"] for site in port["top"])
        assert set(port["top"][0]) == {"site", "size_bytes", "count"}
        assert port["current_bytes"] > 0 and blob
    finally:
        if not was_tracing:
            tracemalloc.stop()


def test_thread_dump_matches_reference_shape():
    port, ref = pprof.thread_dump(), jprof.thread_dump()
    me = threading.current_thread()
    for text in (port, ref):
        assert f"thread {me.ident} [{me.name}]" in text
        assert "test_thread_dump_matches_reference_shape" in text
