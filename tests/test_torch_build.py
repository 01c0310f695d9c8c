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


def kernel_names():
    from anime_illust_image_searcher_tpu_torch.ops import flash_attention, query_scores

    return (flash_attention.KERNEL, flash_attention.KERNEL_F32, query_scores.KERNEL)


@pytest.mark.parametrize("edited", ["query_scores", "flash_attention_f32", "flash_attention"])
def test_every_kernel_source_is_hashed_on_its_own(tmp_path, monkeypatch, edited):
    """The kernels of the port build from csrc/ (attention in bf16 and in f32,
    the query scores); editing one source renames its library and leaves the
    others' as they are, so the f32 attention source never rebuilds the bf16
    kernel."""
    import shutil

    names = kernel_names()
    assert edited in names
    for name in names:
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, name + ".cu")), name
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {n: lib_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    with open(csrc / f"{edited}.cu", "a") as f:
        f.write("// edited\n")
    for name in names:
        assert (lib_path(name) != before[name]) == (name == edited), name


def test_f32_attention_library_name():
    """The f32 attention kernel is a library of its own, named by its source's
    hash like the others."""
    from anime_illust_image_searcher_tpu_torch.ops import flash_attention

    f32, bf16 = lib_path(flash_attention.KERNEL_F32), lib_path(flash_attention.KERNEL)
    assert os.path.dirname(f32) == _build.BUILD_DIR
    assert os.path.basename(f32).startswith("libflash_attention_f32-") and f32.endswith(".so")
    assert os.path.basename(bf16).startswith("libflash_attention-")
    digest = os.path.basename(f32)[len("libflash_attention_f32-"):-len(".so")]
    assert len(digest) == 16 and int(digest, 16) >= 0


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
