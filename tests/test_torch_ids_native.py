"""The native uuid formatter (``native/ids.cc``) behind
``structs.generate_uuids``.

``nids_format`` on bytes seeded with numpy equals the Python formatter
(``structs.format_uuids_twin``) bit for bit; a bulk draw of 10^6 ids has
the 8-4-4-4-12 form and no duplicate; ``structs.generate_uuids`` is the
native call, and a build that fails raises instead of falling back.
"""
import re

import numpy as np
import pytest

from nomad_tpu.structs import structs as js
from nomad_tpu_torch import native
from nomad_tpu_torch.structs import structs as s

UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")


@pytest.mark.parametrize("n", [0, 1, 7, 255, 256, 257, 4096])
def test_native_format_equals_the_python_formatter(n):
    raw = np.random.default_rng(18 + n).integers(
        0, 256, 16 * n, dtype=np.uint8).tobytes()
    got = native.format_uuids(raw)
    assert got == s.format_uuids_twin(raw)
    assert len(got) == n and all(UUID.fullmatch(u) for u in got)


def test_python_formatter_is_the_references_form():
    """The twin formats as the reference's bulk path does
    (``nomad_tpu/structs/structs.py:164-168``): the hex of 16 bytes, cut
    8-4-4-4-12."""
    raw = np.random.default_rng(5).integers(0, 256, 16 * 64,
                                            dtype=np.uint8).tobytes()
    hx = raw.hex()
    want = [f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"
            for h in (hx[32 * i:32 * i + 32] for i in range(64))]
    assert s.format_uuids_twin(raw) == want
    assert all(UUID.fullmatch(u) for u in js.generate_uuids(64))


def test_format_refuses_a_partial_id():
    with pytest.raises(ValueError, match="whole number"):
        native.format_uuids(b"\x00" * 17)


def test_a_million_ids_are_well_formed_and_distinct():
    ids = s.generate_uuids(1_000_000)
    assert len(ids) == 1_000_000
    assert len(set(ids)) == 1_000_000
    assert all(len(u) == 36 for u in ids)
    for u in ids[:: 997]:
        assert UUID.fullmatch(u), u


def test_generate_uuids_is_the_native_call(monkeypatch):
    calls = []
    real = native.generate_uuids

    def spy(n):
        calls.append(n)
        return real(n)

    monkeypatch.setattr(native, "generate_uuids", spy)
    assert len(s.generate_uuids(5)) == 5 and calls == [5]
    assert s.generate_uuids(0) == []


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeUnavailable, match="g.. not found"):
        s.generate_uuids(3)
