"""The kernel build cache of the port (ops/_build.py), on the CPU.

A library is named by a hash of what builds it: the flags, the kernel's source
and every header beside it. So a changed header or flag builds anew, and an
unchanged tree is served the library it already has. Needs no nvcc.
"""

import os

import pytest

from anime_illust_image_searcher_tpu_torch.ops import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\nextern "C" int k() { return 0; }\n')
    (csrc / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    return csrc


def lib_path(name="k"):
    return _build._paths(name)[1]


def test_library_path_is_stable_and_in_the_build_dir(tree):
    first = lib_path()
    assert lib_path() == first
    assert os.path.dirname(first) == _build.BUILD_DIR
    assert os.path.basename(first).startswith("libk-") and first.endswith(".so")


@pytest.mark.parametrize("edit", [
    lambda d: (d / "k.cu").write_text("// edited\n"),
    lambda d: (d / "common.cuh").write_text("#pragma once\n#define X 1\n"),
    lambda d: (d / "extra.cuh").write_text("#pragma once\n"),
    lambda d: (d / "common.cuh").unlink(),
], ids=["source", "header edited", "header added", "header removed"])
def test_library_path_follows_the_sources(tree, edit):
    before = lib_path()
    edit(tree)
    assert lib_path() != before


def test_library_path_ignores_other_files(tree):
    before = lib_path()
    (tree / "notes.txt").write_text("not a source\n")
    (tree / "other.cu").write_text("// another kernel's source\n")
    assert lib_path() == before


@pytest.mark.parametrize("flags", [
    ("-I/usr/local/cutlass/include",),
    ("-lineinfo",),
], ids=["include dir", "other flag"])
def test_library_path_follows_the_flags(tree, monkeypatch, flags):
    before = lib_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + flags)
    changed = lib_path()
    assert changed != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-len(flags)])
    assert lib_path() == before


def test_build_serves_an_up_to_date_library_without_nvcc(tree, monkeypatch):
    def no_nvcc():
        raise AssertionError("nvcc must not run for an up-to-date library")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    os.makedirs(_build.BUILD_DIR)
    open(lib_path(), "wb").close()
    _build.build(["k"])   # nothing to do
    (tree / "common.cuh").write_text("#pragma once\n// changed\n")
    with pytest.raises(AssertionError, match="nvcc must not run"):
        _build.build(["k"])   # the header changed: it would rebuild
