"""The CUDA build helper, as far as it can be held without nvcc: every
library named in ``_cuda.SIGNATURES`` has its source under csrc/, every
source has its entry, the sources ship with the package, and a library is
stale when its source or an included header is newer."""

import os
import re
import time

from scann_torch import _cuda


def test_every_signature_has_its_source_and_entry_points():
    sources = {f[:-3] for f in os.listdir(_cuda.CSRC) if f.endswith(".cu")}
    assert sources == set(_cuda.SIGNATURES)
    assert sources == {"pruned_sq", "pruned_lut", "pruned_codes",
                       "pruned_rows", "fused_scan", "merge_groups"}
    for name, fns in _cuda.SIGNATURES.items():
        text = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
        assert 'extern "C" const char* error_string' in text
        for fn, (args, _) in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
            assert m, fn
            assert len(m.group(1).split(",")) == len(args), fn
        assert os.path.basename(_cuda.source_path(name)) == \
            f"{name}.cu"


def test_sources_ship_with_the_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "pyproject.toml")).read()
    assert '"csrc/*.cu"' in text and '"csrc/*.cuh"' in text
    assert os.path.exists(os.path.join(_cuda.CSRC, "survivors.cuh"))
    for name in _cuda.SIGNATURES:
        text = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
        # Every scorer with the packed-survivor epilogue shares one header;
        # whatever a source includes from csrc/ is there.
        if name.startswith("pruned_"):
            assert '#include "survivors.cuh"' in text
        for header in re.findall(r'#include "([^"]+)"', text):
            assert os.path.exists(os.path.join(_cuda.CSRC, header)), header


def test_new_kernels_state_what_they_replace():
    for name, replaced in (("pruned_rows", "score_work_pallas"),
                           ("fused_scan", "fused_scan_groupmax"),
                           ("merge_groups", "merge_groups_pallas")):
        text = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
        assert replaced in text and "What bounds it on the H100" in text
        assert "__global__" in text and "cublas" not in text.lower()


def test_staleness_sees_source_and_header(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(build))
    assert _cuda.source_files("k") == [str(csrc / "k.cu"),
                                       str(csrc / "h.cuh")]
    assert _cuda.is_stale("k")                      # no library yet
    lib = build / "libk.so"
    lib.write_text("")
    now = time.time()
    os.utime(csrc / "k.cu", (now - 30, now - 30))
    os.utime(csrc / "h.cuh", (now - 30, now - 30))
    os.utime(lib, (now - 20, now - 20))
    assert not _cuda.is_stale("k")
    assert _cuda.build("k") == ""                   # up to date: no nvcc
    os.utime(csrc / "h.cuh", (now - 10, now - 10))  # header touched
    assert _cuda.is_stale("k")
    os.utime(lib, (now - 5, now - 5))
    assert not _cuda.is_stale("k")
    os.utime(csrc / "k.cu", (now, now))             # source touched
    assert _cuda.is_stale("k")


def test_k3_breakdown_edits_still_apply():
    """scann_torch/tools/k3_breakdown.py measures K3 by compiling edited
    copies of its source; every edit must find its text exactly once."""
    from scann_torch.tools import k3_breakdown
    src = open(_cuda.source_path("pruned_lut")).read()
    for edits in k3_breakdown.VARIANTS.values():
        for old, _ in edits:
            assert src.count(old) == 1, old
