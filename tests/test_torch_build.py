"""The kernels' build cache (ops._build), on the CPU: a library is named by a
hash of its source and of the headers the source includes, so an edited
header is rebuilt like an edited source."""

import shutil

from vcr_tpu_torch.ops import _build

SOURCES = ("gru_seq.cu", "gru_seq_dma.cu", "lstm_seq.cu")


def _copy_csrc(tmp_path):
    for path in _build.CSRC.iterdir():
        shutil.copy(path, tmp_path / path.name)
    return tmp_path


def test_digest_changes_with_an_included_header(tmp_path):
    csrc = _copy_csrc(tmp_path)
    before = {name: _build.source_digest(csrc / name) for name in SOURCES}
    assert before == {name: _build.source_digest(_build.CSRC / name) for name in SOURCES}
    header = csrc / "tc_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.source_digest(csrc / name) for name in SOURCES}
    # all three sources hold a tensor-core body that includes the header
    for name in SOURCES:
        assert after[name] != before[name]


def test_digest_follows_nested_includes_once(tmp_path):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n#include "a.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    first = _build.source_digest(tmp_path / "k.cu")
    (tmp_path / "unrelated.cuh").write_text("// edited\n")
    assert _build.source_digest(tmp_path / "k.cu") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.source_digest(tmp_path / "k.cu") != first
