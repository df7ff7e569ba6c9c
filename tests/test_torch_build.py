"""The kernel build (ops/_build.py) on the CPU: a library's name hashes its
source, the headers under csrc/ and the flags, so that an edited header
never meets a library built before the edit.  Nothing is compiled here."""

import tests.torch_threads  # noqa: F401
import os

import pytest

from old_kaldi_git_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "ptx.cuh"\nint k;\n')
    (tmp_path / "ptx.cuh").write_text("// wrappers\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


def test_library_name_is_stable_for_the_same_sources(csrc):
    assert _build._lib_path("k") == _build._lib_path("k")


@pytest.mark.parametrize("edit", ["source", "header", "new_header", "flags"])
def test_library_name_changes_with_any_input_of_the_build(csrc, monkeypatch, edit):
    before = _build._lib_path("k")[1]
    if edit == "source":
        (csrc / "k.cu").write_text('#include "ptx.cuh"\nint k2;\n')
    elif edit == "header":
        (csrc / "ptx.cuh").write_text("// wrappers, edited\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// another\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    after = _build._lib_path("k")[1]
    assert after != before
    assert os.path.dirname(after) == str(csrc / "build")


def test_the_port_sources_share_one_header():
    names = sorted(os.listdir(os.path.join(os.path.dirname(_build.__file__), "csrc")))
    assert "ptx.cuh" in names
    for src in _build.KERNEL_SOURCES:
        assert f"{src}.cu" in names
