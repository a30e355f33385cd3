"""The kernel build key: a library is rebuilt whenever anything its build
reads changes -- its source, any shared header, the flags."""
import pytest

from nomad_tpu_torch import device


@pytest.fixture
def csrc(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\n')
    (src / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(device, "CSRC", src)
    monkeypatch.setattr(device, "BUILD_DIR", tmp_path / "build")
    return src


def test_header_change_changes_the_library_path(csrc):
    before = device._lib_path(csrc / "k.cu")
    assert before == device._lib_path(csrc / "k.cu")
    (csrc / "common.cuh").write_text("// v2\n")
    assert device._lib_path(csrc / "k.cu") != before


def test_new_header_source_and_flags_change_the_library_path(csrc,
                                                              monkeypatch):
    paths = {device._lib_path(csrc / "k.cu")}
    (csrc / "other.cuh").write_text("// new\n")
    paths.add(device._lib_path(csrc / "k.cu"))
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    paths.add(device._lib_path(csrc / "k.cu"))
    monkeypatch.setattr(device, "NVCC_FLAGS", device.NVCC_FLAGS + ("-G",))
    paths.add(device._lib_path(csrc / "k.cu"))
    assert len(paths) == 4
    assert all(p.name.startswith("libk-") for p in paths)


def test_build_reports_a_missing_nvcc_before_compiling(csrc, monkeypatch):
    monkeypatch.setattr(device, "find_nvcc", lambda: None)
    with pytest.raises(device.KernelUnavailable, match="nvcc not found"):
        device.build_kernels()
