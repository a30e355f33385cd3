"""The registry of every fast/reference pair of the port (a copy of
``nomad_tpu/ops/guards.py`` without its environment knobs).

Every component with a fast path and a reference path (the native twins,
the columnar numpy mirror, the resident device mirror, the quantized
encoding) is declared here with the differential guard that compares the
two, the argument that sets the guard's cadence, the argument that asks
for the reference route, and what a mismatch does: it ``raise``-s an
error of its own layer, or it feeds the kernel breaker
(``breaker.record(False)``).  The static pass
(``nomad_tpu_torch/analysis/guardrules.py``) fails the tree when

- a ``native/*.cc`` source has no entry,
- an entry names a guard symbol its module does not define,
- an entry claims a raise or a breaker feed its module does not make, or
- an entry waives a requirement without a written reason.

The reference's entries name environment kill switches and cadence knobs
(``utils/knobs.py``); the port has no knobs (ROADMAP queue 3 item 8(c)),
so an entry names constructor or function arguments instead, and the
static pass has no knob checks.  Entries are data: the guards live beside
the paths they protect.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

__all__ = ["GuardEntry", "REGISTRY", "native_sources", "MISMATCH_ACTIONS"]

#: What a guard mismatch does: ``raise`` (an error of the guard's own
#: layer) or ``breaker`` (``breaker.record(False)``, and the batch runs on
#: the reference route).
MISMATCH_ACTIONS = ("raise", "breaker")


@dataclass(frozen=True)
class GuardEntry:
    name: str
    # "native_twin" | "columnar_mirror" | "device_mirror" | "encoding"
    kind: str
    # The module that owns the guard (dotted path).
    module: str
    # The .cc source this entry claims (native twins only).
    native_source: Optional[str] = None
    # A symbol the module must define (the guard's counter, cadence or
    # check); None only with a waiver.
    guard_symbol: Optional[str] = None
    # The argument that sets the guard's cadence ("" when the guard runs
    # on every call, or there is no guard).
    cadence_arg: str = ""
    # The argument that asks for the reference route.
    reference_route: str = ""
    # What a mismatch does (one of MISMATCH_ACTIONS; "" with a waiver).
    on_mismatch: str = ""
    # The error a "raise" entry raises (its name, made in the module).
    raises: str = ""
    # Waives the guard requirement: MUST carry a reason.
    waiver: str = ""
    # Where the pairing is exercised (a pointer, not checked).
    tests: str = ""


REGISTRY: List[GuardEntry] = [
    GuardEntry(
        name="codec.string_columns",
        kind="native_twin",
        module="nomad_tpu_torch.codec.native",
        native_source="codec.cc",
        guard_symbol="GUARD_EVERY",
        cadence_arg="codec.native.GUARD_EVERY (module setting, default 512)",
        reference_route="codec.native.py_pack_strs / py_split_strs "
                        "(the twins; no switch on the main path)",
        on_mismatch="raise",
        raises="CodecError",
        tests="tests/test_torch_codec.py (twin corpus), the codec drill",
    ),
    GuardEntry(
        name="decode.packed_results",
        kind="native_twin",
        module="nomad_tpu_torch.ops.decode",
        native_source="decode.cc",
        guard_symbol="GUARD_RUNS",
        cadence_arg="TorchBatchScheduler(decode_guard_every=64), "
                    "schedule_batch(decode_guard_every=64)",
        reference_route="TorchBatchScheduler(native_decode=False), "
                        "schedule_batch(native_decode=False)",
        on_mismatch="raise",
        raises="DecodeGuardError",
        tests="tests/test_torch_decode_native.py, the residue drill",
    ),
    GuardEntry(
        name="wal.group_commit",
        kind="native_twin",
        module="nomad_tpu_torch.server.raft",
        native_source="wal.cc",
        reference_route="FileLog(native=False)",
        waiver=(
            "durability backend: an online differential guard would "
            "double every fsync; the pure-Python synced-seq twin "
            "(FileLog(native=False)) is pinned equivalent by "
            "tests/test_torch_wal.py and the torn-frame drills instead"),
        tests="tests/test_torch_wal.py, the wal drill, the sanitized corpus",
    ),
    GuardEntry(
        name="ids.bulk_uuids",
        kind="native_twin",
        module="nomad_tpu_torch.structs.structs",
        native_source="ids.cc",
        reference_route="structs.format_uuids_twin (tests only)",
        waiver=(
            "random output has no deterministic twin to bit-compare; the "
            "formatter (nids_format) is held bit for bit against "
            "format_uuids_twin and the form and uniqueness of a bulk "
            "draw are asserted by tests/test_torch_ids_native.py"),
        tests="tests/test_torch_ids_native.py, the sanitized corpus",
    ),
    GuardEntry(
        name="columnar.node_table",
        kind="columnar_mirror",
        module="nomad_tpu_torch.state.columnar",
        guard_symbol="GUARD_RUNS",
        cadence_arg="TorchBatchScheduler / PlanApplier / ServerConfig"
                    "(columnar_guard_every=16)",
        reference_route="StateStore(columnar=False)",
        on_mismatch="breaker",
        tests="tests/test_torch_columnar.py, the columnar drill",
    ),
    GuardEntry(
        name="columnar.usage_matrix",
        kind="columnar_mirror",
        module="nomad_tpu_torch.state.columnar",
        guard_symbol="USAGE_GUARD_RUNS",
        cadence_arg="TorchBatchScheduler / PlanApplier / ServerConfig"
                    "(columnar_guard_every=16)",
        reference_route="StateStore(columnar=False)",
        on_mismatch="breaker",
        tests="tests/test_torch_columnar.py usage-guard cases",
    ),
    GuardEntry(
        name="resident.device_mirror",
        kind="device_mirror",
        module="nomad_tpu_torch.ops.resident",
        guard_symbol="GUARD_RUNS",
        cadence_arg="TorchBatchScheduler(guard_every=64)",
        reference_route="TorchBatchScheduler(resident=False) or "
                        "(resident_device=False)",
        on_mismatch="breaker",
        tests="tests/test_torch_resident.py, the residency, residue and "
              "mesh drills (per-shard attribution)",
    ),
    GuardEntry(
        name="encode.quantized_rows",
        kind="encoding",
        module="nomad_tpu_torch.ops.resident",
        guard_symbol="check_quant_roundtrip",
        cadence_arg="",   # every quantized encode
        reference_route="exact int32 rows (taken on a mismatch)",
        on_mismatch="breaker",
        tests="tests/test_torch_resident.py, the fused and residue drills",
    ),
]


def native_sources() -> List[str]:
    """The .cc files the registry claims (guardrules compares this with
    the contents of ``nomad_tpu_torch/native/``)."""
    return [e.native_source for e in REGISTRY
            if e.native_source is not None]
