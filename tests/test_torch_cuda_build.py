"""The CUDA build helper, as far as it can be held without nvcc: every
library named in ``_cuda.SIGNATURES`` has its source under csrc/, every
source has its entry, the sources ship with the package, and a library is
stale when its source or an included header is newer."""

import os
import re
import time

import pytest

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


def _with_headers(name):
    """csrc/<name>.cu and the csrc/ headers it includes, as one text."""
    text = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
    for header in re.findall(r'#include "([^"]+)"', text):
        text += open(os.path.join(_cuda.CSRC, header)).read()
    return text


def test_new_kernels_state_what_they_replace():
    """Each source names the TPU kernel it replaces and what bounds it; the
    kernel itself (K1 and K2 share theirs, csrc/tile_mma.cuh) is written
    here, with no library GEMM."""
    for name, replaced in (("pruned_sq", "score_work_pallas_sq"),
                           ("pruned_rows", "score_work_pallas"),
                           ("fused_scan", "fused_scan_groupmax"),
                           ("merge_groups", "merge_groups_pallas")):
        source = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
        assert replaced in source and "What bounds it on the H100" in source
        text = _with_headers(name)
        assert "__global__" in text and "cublas" not in text.lower()


def test_k1_and_k2_share_the_tensor_core_tile_product():
    """K1 and K2 run their products on bf16 mma.sync from one header, with
    no f32 fmaf product loop left in either."""
    header = open(os.path.join(_cuda.CSRC, "tile_mma.cuh")).read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "fmaf" not in header
    for name in ("pruned_sq", "pruned_rows"):
        source = open(os.path.join(_cuda.CSRC, f"{name}.cu")).read()
        assert '#include "tile_mma.cuh"' in source
        assert "fmaf" not in source and "__global__" not in source
        assert f"{name}_occupancy" in _cuda.SIGNATURES[name]


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
    from scann_torch.tools.variants import apply_edits
    src = open(_cuda.source_path("pruned_lut")).read()
    for edits in k3_breakdown.VARIANTS.values():
        assert apply_edits(src, edits) != src or not edits


def test_tile_breakdown_edits_still_apply():
    """scann_torch/tools/tile_breakdown.py measures K1 and K2 by compiling
    edited copies of csrc/tile_mma.cuh; every edit must find its text
    exactly once."""
    from scann_torch.tools import tile_breakdown
    from scann_torch.tools.variants import apply_edits
    src = open(os.path.join(_cuda.CSRC, "tile_mma.cuh")).read()
    for edits in tile_breakdown.VARIANTS.values():
        assert apply_edits(src, edits) != src or not edits


def test_variant_edits_refuse_text_not_found_exactly_once():
    from scann_torch.tools.variants import apply_edits
    assert apply_edits("a b c", [("b", "x"), ("x c", "y")]) == "a y"
    for edits in ([("d", "x")], [("a", "b"), ("b", "x")]):
        with pytest.raises(RuntimeError, match="no longer holds"):
            apply_edits("a b c", edits)
