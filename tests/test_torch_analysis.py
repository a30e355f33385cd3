"""The port's static analysis pass (``nomad_tpu_torch/analysis``), the
cases of ``tests/test_analysis.py`` that belong to its rule families
(lock discipline, guard coverage, and device discipline, the reference's
jaxrules), each on a seeded source snippet or a planted copy, and the
whole tree: zero unsuppressed violations, every allowlist entry with
a reason and a match, every source file scanned, and the sanitized native
corpus clean (or skipped with its reason where the runtimes are
missing).
"""
from __future__ import annotations

import ast
import os
import textwrap

import pytest

from nomad_tpu_torch.analysis import (RULE_FAMILIES, Allowlist, SourceFile,
                                      devicerules, guardrules,
                                      iter_source_files, load_tree,
                                      lockrules, repo_root, run_checks)
from nomad_tpu_torch.analysis.__main__ import main as analysis_main

ROOT = repo_root()


def _sf(path: str, source: str) -> SourceFile:
    source = textwrap.dedent(source)
    return SourceFile(path=path, abspath=os.path.join("/fake", path),
                      source=source, tree=ast.parse(source))


def _lock(source, path="nomad_tpu_torch/server/fake.py"):
    return lockrules.check(ROOT, [_sf(path, source)])


# -- lock discipline ---------------------------------------------------------

def test_fsync_under_lock_fires():
    # The WAL append fsyncs while the log lock is held: group commit is
    # impossible.
    out = _lock("""
        import os
        import threading
        class RaftLog:
            def __init__(self):
                self._l = threading.Lock()
            def apply(self, entry):
                with self._l:
                    self._fh.write(entry)
                    os.fsync(self._fh.fileno())
        """)
    assert any(v.rule == "lock-blocking" and "fsync" in v.detail
               for v in out), out


def test_drain_under_lock_fires_through_a_helper():
    # The snapshot path drains the apply sequencer (a sleep-poll loop)
    # while the log lock is held, through a same-module helper.
    out = _lock("""
        import threading
        import time
        class FileLog:
            def __init__(self):
                self._l = threading.RLock()
            def _drain_appliers(self):
                while self._inflight:
                    time.sleep(0.01)
            def snapshot(self):
                with self._l:
                    self._drain_appliers()
        """)
    assert any(v.rule == "lock-blocking" and "_drain_appliers" in v.detail
               for v in out), out


def test_lock_order_cycle_fires_with_witness():
    out = _lock("""
        import threading
        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
            def fwd(self):
                with self._a:
                    with self._b:
                        pass
            def rev(self):
                with self._b:
                    with self._a:
                        pass
        """)
    cyc = [v for v in out if v.rule == "lock-order"]
    assert len(cyc) == 1
    assert "_a" in cyc[0].message and "_b" in cyc[0].message
    # The witness names each edge's site.
    assert cyc[0].message.count("nomad_tpu_torch/server/fake.py:") == 2


def test_condition_wait_is_not_blocking():
    out = _lock("""
        import threading
        class Broker:
            def __init__(self):
                self._l = threading.RLock()
                self._cond = threading.Condition(self._l)
            def dequeue(self):
                with self._l:
                    while not self._ready:
                        self._cond.wait(1.0)
        """)
    assert not [v for v in out if v.rule == "lock-blocking"], out


def test_clean_region_is_silent():
    out = _lock("""
        import os
        import threading
        class Log:
            def __init__(self):
                self._l = threading.Lock()
            def apply(self, entry):
                with self._l:
                    seq = self._wal.write(entry)
                os.fsync(self._fh.fileno())
        """)
    assert out == []


@pytest.mark.parametrize("call,kind", [
    ("torch.cuda.synchronize()", "synchronize"),
    ("self._event.synchronize()", "synchronize"),
    ("used.item()", "item"),
    ("used.tolist()", "tolist"),
    ("self.used_dev.cpu()", "cpu"),
])
def test_torch_device_sync_under_lock_fires(call, kind):
    out = _lock(f"""
        import threading
        import torch
        class Mirror:
            def __init__(self):
                self._lock = threading.Lock()
            def read(self, used):
                with self._lock:
                    return {call}
        """)
    hits = [v for v in out if v.rule == "lock-blocking"]
    assert len(hits) == 1 and hits[0].detail == f"{kind}:under:_lock", out


def test_torch_device_sync_outside_the_lock_is_silent():
    out = _lock("""
        import threading
        import torch
        class Tracer:
            def __init__(self):
                self._lock = threading.Lock()
            def stop(self):
                torch.cuda.synchronize()
                with self._lock:
                    self._active = None
        """)
    assert out == []


# -- guard coverage ----------------------------------------------------------

def test_real_tree_guard_coverage_is_clean():
    assert guardrules.check(ROOT, load_tree(ROOT)) == []


def _fake_tree(tmp_path, registry, modules=None, cc=("rogue.cc",)):
    native = tmp_path / "nomad_tpu_torch" / "native"
    ops = tmp_path / "nomad_tpu_torch" / "ops"
    native.mkdir(parents=True)
    ops.mkdir(parents=True)
    for name in cc:
        (native / name).write_text("// native code\n")
    guards_src = open(os.path.join(ROOT, guardrules.GUARDS_PATH)).read()
    head = guards_src.split("REGISTRY: List[GuardEntry] = [")[0]
    tail = "def native_sources()" + guards_src.split(
        "def native_sources()")[1]
    (ops / "guards.py").write_text(
        head + "REGISTRY: List[GuardEntry] = [\n" + registry + "]\n\n\n"
        + tail)
    files = []
    for rel, src in (modules or {}).items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
        files.append(_sf(rel, src))
    return guardrules.check(str(tmp_path), files)


def test_unclaimed_native_source_fires(tmp_path):
    out = _fake_tree(tmp_path, "")
    assert [v.detail for v in out] == ["unclaimed-native-source"]
    assert out[0].path == "nomad_tpu_torch/native/rogue.cc"


GOOD_MODULE = {"nomad_tpu_torch/ops/fast.py": """
    GUARD_RUNS = 0
    class FastError(RuntimeError):
        pass
    def fast(x, breaker=None):
        if x != x:
            raise FastError("diverged")
        if breaker is not None and x < 0:
            breaker.record(False)
        return x
    """}


def _entry(**kw):
    base = dict(name="fast.path", kind="native_twin",
                module="nomad_tpu_torch.ops.fast", native_source="rogue.cc",
                guard_symbol="GUARD_RUNS", reference_route="fast(native=False)",
                on_mismatch="raise", raises="FastError")
    base.update(kw)
    return ("    GuardEntry(" + ", ".join(f"{k}={v!r}" for k, v in base.items())
            + "),\n")


def test_a_true_entry_is_clean(tmp_path):
    assert _fake_tree(tmp_path, _entry(), GOOD_MODULE) == []


@pytest.mark.parametrize("kw,detail", [
    ({"guard_symbol": "NOT_THERE"}, "fast.path:missing-guard-symbol"),
    ({"raises": "OtherError"}, "fast.path:missing-raise"),
    ({"on_mismatch": "breaker", "module": "nomad_tpu_torch.ops.quiet"},
     "fast.path:missing-breaker-feed"),
    ({"guard_symbol": None}, "fast.path:unjustified-no-guard"),
    ({"on_mismatch": ""}, "fast.path:unjustified-no-action"),
    ({"reference_route": ""}, "fast.path:no-reference-route"),
    ({"module": "nomad_tpu_torch.ops.gone"}, "fast.path:missing-module"),
    ({"native_source": "other.cc"}, "phantom-native-source:other.cc"),
])
def test_an_untrue_entry_fires(tmp_path, kw, detail):
    modules = dict(GOOD_MODULE)
    modules["nomad_tpu_torch/ops/quiet.py"] = "GUARD_RUNS = 0\n"
    out = _fake_tree(tmp_path, _entry(**kw), modules)
    assert detail in [v.detail for v in out], out


def test_a_waiver_must_carry_its_reason(tmp_path):
    waived = _entry(guard_symbol=None, on_mismatch="", raises="",
                    waiver="random output has no twin to compare")
    assert _fake_tree(tmp_path, waived, GOOD_MODULE) == []
    blank = _entry(guard_symbol=None, on_mismatch="", raises="",
                   waiver="   ")
    details = {v.detail for v in _fake_tree(tmp_path / "b", blank,
                                            GOOD_MODULE)}
    assert {"fast.path:unjustified-no-guard",
            "fast.path:unjustified-no-action"} <= details


def test_registry_claims_every_native_source():
    from nomad_tpu_torch.ops import guards

    native_dir = os.path.join(ROOT, guardrules.NATIVE_DIR)
    assert sorted(guards.native_sources()) == sorted(
        f for f in os.listdir(native_dir) if f.endswith(".cc"))
    assert sorted(guards.native_sources()) == [
        "codec.cc", "decode.cc", "ids.cc", "wal.cc"]


# -- device discipline -------------------------------------------------------

KERNELS_PY = "nomad_tpu_torch/ops/kernels.py"


def _device(source, path="nomad_tpu_torch/ops/fake.py"):
    return devicerules.check(ROOT, [_sf(path, source)])


def _real(path):
    with open(os.path.join(ROOT, path), encoding="utf-8") as fh:
        return fh.read()


def test_planted_item_in_a_hot_module_is_flagged():
    """A copy of ops/kernels.py with an ``.item()`` planted in the round
    kernel's loop: one new torch-host-sync finding, which the tree's
    allowlist does not excuse."""
    src = _real(KERNELS_PY)
    anchor = "        rounds += 1\n        placed, left, fits, round_steps"
    assert anchor in src
    planted = src.replace(anchor, "        t['used'].sum().item()\n" + anchor)
    before = {v.key for v in devicerules.check(ROOT, [_sf(KERNELS_PY, src)])}
    after = devicerules.check(ROOT, [_sf(KERNELS_PY, planted)])
    new = [v for v in after if v.key not in before]
    assert [v.key for v in new] == [
        f"torch-host-sync {KERNELS_PY}::_kernel_rounds::t.item"]
    allow = Allowlist(os.path.join(ROOT, "nomad_tpu_torch", "analysis",
                                   "allowlist.txt"))
    assert not allow.suppresses(new[0])


def test_host_syncs_of_tensors_fire_and_numpy_reads_do_not():
    out = _device("""
        import numpy as np
        import torch
        def f(x: torch.Tensor, y):
            a = torch.zeros(3)
            n = int(a.sum())
            b = np.zeros(3)
            m = int(b.sum()) + len(b.tolist()) + y.count(1)
            t = a.tolist()
            torch.cuda.synchronize()
            return bool(x[0]), float(a.max()), a.cpu().numpy()
        """)
    assert sorted(v.detail for v in out) == [
        "a.cpu", "a.tolist", "bool(x)", "float(a)", "int(a)",
        "torch.cuda.synchronize"]
    assert all(v.rule == "torch-host-sync" and v.qualname == "f"
               for v in out)


def test_host_sync_rule_covers_only_the_hot_modules():
    src = "import torch\ndef f():\n    return torch.zeros(1).item()\n"
    assert _device(src, "nomad_tpu_torch/ops/x.py")
    assert _device(src, "nomad_tpu_torch/parallel/x.py")
    assert not _device(src, "nomad_tpu_torch/server/x.py")


def test_planted_launcher_without_note_signature_is_flagged():
    launcher = """
        from . import fused_score
        def launch(x):
            fn = fused_score._fn("scored_rows")
            return fn(x.data_ptr())
        """
    out = _device(launcher)
    assert [(v.rule, v.detail) for v in out] == [
        ("torch-note-signature", "launch-in:launch")]
    noted = launcher.replace(
        "            fn = fused_score._fn",
        "            kernels.note_signature('x', ())\n"
        "            fn = fused_score._fn")
    assert _device(noted) == []


def test_round_kernel_loop_reads_the_host_once_a_round():
    """The kernel route's only host reads are the first round's test and
    the status read of each round; every module that launches a kernel
    registers its signatures."""
    files = load_tree(ROOT)
    out = devicerules.check(ROOT, files)
    loop = sorted(v.detail for v in out
                  if v.qualname == "_kernel_rounds")
    assert loop == ["first.tolist", "status.tolist"]
    assert not [v for v in out if v.rule == "torch-note-signature"]


def test_device_discipline_is_clean_on_the_tree():
    active, suppressed = run_checks(ROOT, rules=["device-discipline"])
    assert active == [], "\n".join(v.render() for v in active)
    assert any(v.rule == "torch-host-sync" for v in suppressed)


def test_stale_device_entry_fails(tmp_path):
    allow = tmp_path / "allow.txt"
    allow.write_text(f"torch-host-sync {KERNELS_PY}::gone::x.item  "
                     "# covers nothing\n")
    active, _ = run_checks(ROOT, allowlist_path=str(allow))
    assert any(v.rule == "allowlist" and "stale" in v.detail
               and "gone" in v.detail for v in active)


# -- the allowlist -----------------------------------------------------------

def test_stale_entry_fails(tmp_path):
    allow = tmp_path / "allow.txt"
    allow.write_text("lock-blocking nomad_tpu_torch/nope.py::f::x  "
                     "# covers nothing\n")
    active, _ = run_checks(ROOT, allowlist_path=str(allow))
    assert any(v.rule == "allowlist" and "stale" in v.detail
               for v in active)


def test_entry_without_reason_fails(tmp_path):
    allow = tmp_path / "allow.txt"
    allow.write_text("lock-blocking nomad_tpu_torch/x.py::f::y\n"
                     "lock-blocking nomad_tpu_torch/x.py::f::z  #   \n")
    active, _ = run_checks(ROOT, allowlist_path=str(allow))
    assert len([v for v in active if v.rule == "allowlist"
                and "malformed" in v.detail]) == 2


def test_every_allowlist_entry_has_a_reason_and_a_match():
    allow = Allowlist(os.path.join(ROOT, "nomad_tpu_torch", "analysis",
                                   "allowlist.txt"))
    assert allow.malformed == [] and allow.entries
    _, suppressed = run_checks(ROOT)
    for pattern, reason, _ in allow.entries:
        assert reason
        assert any(v.key == pattern for v in suppressed), pattern


def test_shared_findings_keep_the_references_reason():
    """An allowlisted finding the reference's allowlist also excuses (the
    same rule, qualname and detail in the same module) carries the
    reference's reason."""
    mine = Allowlist(os.path.join(ROOT, "nomad_tpu_torch", "analysis",
                                  "allowlist.txt"))
    ref = Allowlist(os.path.join(ROOT, "nomad_tpu", "analysis",
                                 "allowlist.txt"))

    def tail(pattern):
        rule, rest = pattern.split(" ", 1)
        path, q = rest.split("::", 1)
        return rule, path.split("/", 1)[1], q

    ref_reasons = {tail(p): r for p, r, _ in ref.entries}
    shared = [(p, r) for p, r, _ in mine.entries if tail(p) in ref_reasons]
    assert len(shared) >= 8
    for pattern, reason in shared:
        assert reason == ref_reasons[tail(pattern)], pattern


# -- the tree ----------------------------------------------------------------

def test_whole_tree_has_zero_unsuppressed_violations():
    active, suppressed = run_checks(ROOT)
    assert active == [], "\n".join(v.render() for v in active)
    assert len(suppressed) >= 10


def test_every_source_file_is_scanned():
    paths = iter_source_files(ROOT)
    assert "nomad_tpu_torch/server/raft.py" in paths
    assert "nomad_tpu_torch/analysis/lockrules.py" in paths
    assert "chip_smoke.py" in paths
    assert not any(p.startswith("tests/") for p in paths)
    assert not any(p.startswith("nomad_tpu/") for p in paths)
    on_disk = {os.path.relpath(os.path.join(d, f), ROOT)
               for d, _, fs in os.walk(os.path.join(ROOT, "nomad_tpu_torch"))
               for f in fs if f.endswith(".py")}
    assert on_disk == {p for p in paths if p != "chip_smoke.py"}


def test_unknown_rule_family_raises():
    assert RULE_FAMILIES == ("lock-discipline", "guard-coverage",
                             "device-discipline")
    with pytest.raises(ValueError, match="unknown rule family"):
        run_checks(ROOT, rules=["knob-registry"])


def test_check_command_exits_zero_on_the_tree(capsys):
    assert analysis_main(["--check"]) == 0
    assert "analysis: clean" in capsys.readouterr().out


# -- the sanitized native corpus ---------------------------------------------

def test_sanitized_corpus_is_clean_or_skipped_with_its_reason():
    from nomad_tpu_torch import native
    from nomad_tpu_torch.native.__main__ import run_sanitized

    lines = []
    verdict = run_sanitized(seed=0, log=lines.append)
    if not native.sanitizer_runtimes():
        assert isinstance(verdict, tuple) and verdict[0] == "skip"
        assert verdict[1]
    else:
        # g++ has the runtimes here: the corpus must run, and pass.
        assert verdict == "ok", (verdict, lines)
        assert any("every native corpus clean" in ln for ln in lines)
