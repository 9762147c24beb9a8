"""The card probes' source variants, checked without a card: every
diagnostic edit still finds its text in the kernel source it edits, so no
variant can rot silently when a kernel changes."""

import pytest

from tpu80211_torch.kernels import _build, _variants
from tpu80211_torch.kernels import detect_variants as DV
from tpu80211_torch.kernels import fused_chain_variants as FV
from tpu80211_torch.kernels import gen_chain_variants as GV
from tpu80211_torch.kernels import raw_gen_chain_variants as V

CASES = ([(V.SOURCE, name, edits) for name, edits in V.DIAGNOSTICS.items()]
         + [(V.PLACE_SOURCE, name, edits) for name, edits in V.PLACE_DIAGNOSTICS.items()]
         + [(_build.CSRC / DV.HEADER, name, edits) for name, edits in DV.DIAGNOSTICS.items()]
         + [(DV.SOURCES["raw_chain"], name, edits)
            for name, edits in DV.CHAIN_DIAGNOSTICS.items()]
         + [(_build.CSRC / FV.HEADER, "chain-" + name, edits)
            for name, edits in FV.DIAGNOSTICS.items()]
         + [(FV.SOURCE, "chain-" + name, edits) for name, edits in FV.SOURCE_DIAGNOSTICS.items()]
         # the parent's per-sample library sincos lines live on as the guard's fallback
         + [(_build.CSRC / FV.HEADER, "chain-" + name, edits)
            for name, edits in {**FV.PARENT_DIAGNOSTICS, **FV.TREE_DIAGNOSTICS}.items()]
         + [(_build.CSRC / GV.HEADER, "gen-" + name, edits)
            for name, edits in GV.GEN_DIAGNOSTICS.items()]
         + [(GV.SOURCE, "gen-" + name, edits)
            for name, edits in {**GV.SOURCE_DIAGNOSTICS, **GV.DIAGNOSTICS}.items()])


@pytest.mark.parametrize("source, name, edits", CASES, ids=[c[1] for c in CASES])
def test_diagnostic_variants_still_apply_to_the_kernel_sources(source, name, edits):
    """Each OLD of the edit is in the source, and the variant differs from
    it."""
    text = source.read_text()
    for edit in edits.split(" ;; "):
        old = edit.split(" -> ")[0].encode().decode("unicode_escape")
        assert old in text, (name, old)
    assert _variants.variant_source(source, edits) != text


def test_variant_source_raises_on_a_missing_old(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("int a = 1;\nint b = 2;\n")
    assert _variants.variant_source(src, "int a = 1; -> int a = 3; ;; b = 2 -> b = 4") == (
        "int a = 3;\nint b = 4;\n")
    assert _variants.variant_source(src, "int a = 1;\\nint b -> int c") == "int c = 2;\n"
    with pytest.raises(ValueError, match="not in k.cu"):
        _variants.variant_source(src, "int a = 1; -> x ;; int z -> y")


def test_header_edit_lands_in_the_variants_own_directory(tmp_path):
    """A variant that edits detect.cuh writes the edited header beside its
    copy of detect.cu, where the quoted #include finds it first; csrc/ is
    left as it was, and a string of edits still edits the source alone."""
    header = _build.CSRC / DV.HEADER
    before = {p.name: p.read_bytes() for p in _build.CSRC.iterdir()}
    edits = DV.DIAGNOSTICS["no_mf"]
    src = _variants.write_variant(DV.SOURCES["detect"], {DV.HEADER: edits}, tmp_path / "no_mf")
    assert src == tmp_path / "no_mf" / "detect.cu"
    assert src.read_text() == DV.SOURCES["detect"].read_text()
    assert '#include "detect.cuh"' in src.read_text()
    assert (src.parent / DV.HEADER).read_text() == _variants.variant_source(header, edits)
    assert (src.parent / DV.HEADER).read_text() != header.read_text()
    assert {p.name: p.read_bytes() for p in _build.CSRC.iterdir()} == before
    plain = _variants.write_variant(V.SOURCE, V.DIAGNOSTICS["no_idft"], tmp_path / "no_idft")
    assert sorted(p.name for p in plain.parent.iterdir()) == ["raw_gen_chain.cu"]
    assert plain.read_text() == _variants.variant_source(V.SOURCE, V.DIAGNOSTICS["no_idft"])


def test_probe_needs_a_card(monkeypatch, capsys):
    """Without a CUDA device the probe says so and exits 1, before building."""
    monkeypatch.setattr(V.torch.cuda, "is_available", lambda: False)
    assert V.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_detect_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(DV.torch.cuda, "is_available", lambda: False)
    assert DV.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_chain_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(FV.torch.cuda, "is_available", lambda: False)
    assert FV.main(["--parent", "elsewhere"]) == 1
    assert "no CUDA device" in capsys.readouterr().err



def test_chain_probe_builds_the_derotation_variants_into_raw_chain():
    """The derotation's variants are built into raw_chain.cu as well as
    fused_chain.cu; the parent's run builds only its own; count_fallbacks
    adds its counters inside the chain namespace and its reader once, after
    it."""
    fused, raw = FV.variants(parent=True)
    assert list(fused) == ["as_is", "f32_sincos", "no_sincos"] and raw == fused
    fused, raw = FV.variants(parent=False)
    assert list(raw) == ["as_is", "library_sincos", "count_fallbacks"]
    assert {"no_dft", "no_ring", "library_sincos", "count_fallbacks"} <= set(fused)
    text = _variants.variant_source(_build.CSRC / FV.HEADER, FV.TREE_DIAGNOSTICS["count_fallbacks"])
    assert text.count('extern "C" int chain_library_calls') == 1
    assert text.index("__shared__ unsigned int block_calls[2];") < text.index("constexpr int N_SC")
    assert text.index('extern "C" int chain_library_calls') > text.index("}  // namespace chain")
    assert text.count("atomicAdd(&block_calls[") == 2 and text.count("atomicAdd(&library_calls[") == 1


def test_gen_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(GV.torch.cuda, "is_available", lambda: False)
    assert GV.main(["--parent", "elsewhere"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_gen_probe_adds_the_attributes_entry_to_the_parents_builds(tmp_path):
    """The parent's gen_chain.cu had no gen_chain_attributes: every parent
    variant gains one (for static shared memory: the parent's kernel used no
    other), before the error-string entry; the tree's variants leave the
    source's own alone."""
    assert GV.PARENT_ATTRIBUTES.startswith('extern "C" int gen_chain_attributes(int eq_bf16, ')
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0)" in (
        GV.PARENT_ATTRIBUTES)
    src = tmp_path / "gen_chain.cu"
    src.write_text('int x;\nextern "C" const char* gen_chain_error_string(int err) {\n}\n')
    for name, edits in GV.variants(parent=True).items():
        text = _variants.variant_source(src, edits[GV.SOURCE.name].split(" ;; ")[-1])
        assert text.count("gen_chain_attributes") == 1, name
        assert text.index("gen_chain_attributes") < text.index("gen_chain_error_string"), name
    tree = GV.variants(parent=False)
    assert tree["as_is"] == {} and "libm_box_muller" in tree
    assert all("gen_chain_attributes" not in e.get(GV.SOURCE.name, "") for e in tree.values())
