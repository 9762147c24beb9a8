"""The boundary between the port and its CUDA libraries
(``tpu80211_torch/kernels/_ffi.py``), on the CPU: the plane checker's
rejections and their exception types, the launch helper's refusal of
tensors off the card before any library loads, and each wrapper's table of
ctypes signatures against the ``extern "C"`` declarations in ``csrc/``."""

import functools
import re

import pytest
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import _build, _ffi
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import gen_chain as G
from tpu80211_torch.kernels import mmse_solve as M
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.kernels import raw_gen_chain as RG

LIBS = (F.LIB, R.LIB, D.LIB, G.LIB, RG.LIB, M.LIB)
EXPORTS = [(lib, export) for lib in LIBS for export in lib.signatures]
LAUNCHES = [(lib, export) for lib, export in EXPORTS if export.endswith("_launch")]


# -- the plane checker --------------------------------------------------------------

def _planes(shape=(53, 16), dtype=torch.float32):
    return Cplx(torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype))


BAD_PLANES = {
    "shape": (lambda: _planes((53, 15)), torch.float32, ValueError),
    "dtype": (lambda: _planes(dtype=torch.float64), torch.float32, ValueError),
    "dtype-of-a-set": (lambda: _planes(dtype=torch.float16), (torch.float32, torch.bfloat16),
                       TypeError),
    "device": (lambda: _planes().map(lambda t: t.to("meta")), torch.float32, ValueError),
    "contiguity": (lambda: Cplx(torch.zeros(16, 53).T, torch.zeros(53, 16)), torch.float32,
                   ValueError),
}


@pytest.mark.parametrize("case", list(BAD_PLANES))
def test_plane_checker_rejects(case):
    make, dtype, err = BAD_PLANES[case]
    with pytest.raises(err, match="txs"):
        _ffi.check_planes("txs", make(), (53, 16), dtype, torch.device("cpu"))


def test_plane_checker_takes_good_planes():
    _ffi.check_planes("txs", _planes(), (53, 16), torch.float32, torch.device("cpu"))
    _ffi.check_planes("x", _planes(dtype=torch.bfloat16), torch.Size([53, 16]), _ffi.STORAGE,
                      torch.device("cpu"))


def _lts():
    return Cplx(torch.zeros(64), torch.zeros(64))


def _streams(ns=1408, b=4, dtype=torch.float32):
    return Cplx(torch.zeros(ns, b, dtype=dtype), torch.zeros(ns, b, dtype=dtype))


# each shared check at each site that takes it: a bad tx spectrum, a bad
# equalize_with, a bad lts_ref, bad streams, with the type each raised before
SHARED_CHECKS = {
    "fused_chain-txs": (lambda: F.fused_chain(
        _streams(1200), _streams(160), F.TxConst(_planes((53, 15)), _planes((53, 1))),
        F.chain_consts("cpu")), ValueError),
    "raw_chain-tpre": (lambda: R.raw_chain_plain(
        _streams(), _lts(), _planes(), _planes((53, 1), torch.bfloat16)), ValueError),
    "raw_chain-equalize_with": (lambda: R.raw_chain_plain(
        _streams(), _lts(), _planes(), _planes((53, 1)), equalize_with="h_cubic"), ValueError),
    "gen_chain-txs": (lambda: G.gen_chain_plain(
        0, 128, _planes().map(lambda t: t.T.contiguous().T), _planes((53, 1))), ValueError),
    "raw_gen_chain-txs": (lambda: RG.gen_raw_plain(
        0, 128, _planes((53, 8)), _planes((53, 1)), _lts(), ns=1408), ValueError),
    "raw_gen_chain-lts_ref": (lambda: RG.gen_raw_plain(
        0, 128, _planes(), _planes((53, 1)), Cplx(torch.zeros(63), torch.zeros(63)), ns=1408),
        ValueError),
    "raw_gen_chain-equalize_with": (lambda: RG.gen_raw_plain(
        0, 128, _planes(), _planes((53, 1)), _lts(), ns=1408, equalize_with="h_lt"), ValueError),
    "detect-lts_ref": (lambda: D.detect_plain(
        _streams(), _lts().map(lambda t: t.double())), ValueError),
    "detect-streams-dtype": (lambda: D.detect_plain(
        _streams(dtype=torch.float16), _lts()), TypeError),
    "detect-streams-pair": (lambda: D.detect_plain(
        Cplx(torch.zeros(1408, 4), torch.zeros(1408, 4, dtype=torch.bfloat16)), _lts()), TypeError),
    "detect-streams-shape": (lambda: D.detect_plain(
        Cplx(torch.zeros(1408, 4), torch.zeros(1408, 3)), _lts()), ValueError),
    "place-noise-dtype": (lambda: D.place_plain(
        _streams(64, 3), _streams(64, 3, torch.int8), torch.zeros(3, dtype=torch.int32)),
        TypeError),
    "place-noise-shape": (lambda: D.place_plain(
        _streams(64, 3), _streams(64, 4), torch.zeros(3, dtype=torch.int32)), ValueError),
}


@pytest.mark.parametrize("case", list(SHARED_CHECKS))
def test_each_check_site_raises_its_type(case):
    call, err = SHARED_CHECKS[case]
    with pytest.raises(err):
        call()


# -- the launch helper ----------------------------------------------------------------

@pytest.mark.parametrize("lib, export", LAUNCHES, ids=[e for _, e in LAUNCHES])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_launch_refuses_tensors_off_the_card_before_loading(lib, export, device, monkeypatch):
    """The helper raises "CUDA tensors only" before it builds or loads the
    library: the export is still the unloaded first call afterwards."""
    def refuse(*args):
        raise AssertionError("a library was built")

    monkeypatch.setattr(_build, "build", refuse)
    fresh = _ffi.Library(lib.name, lib.signatures)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        _ffi.launch(getattr(fresh, export), [torch.zeros(4, device=device), None], 1, 2)
    assert isinstance(getattr(fresh, export), functools.partial)


def test_pointer_table_maps_none_to_null():
    t = torch.zeros(3)
    table = _ffi.pointer_table([t, None, t])
    assert list(table) == [t.data_ptr(), None, t.data_ptr()]


# -- each signature table against its C declaration ----------------------------------

# C parameter types and the ctypes types that pass them
C_TYPES = {"const void* const*": _ffi.PTR, "void*": _ffi.PTR, "int": _ffi.INT,
           "float": _ffi.FLOAT, "double": _ffi.DOUBLE, "long long": _ffi.LONG_LONG,
           "int*": _ffi.INT_PTR}
DECLARATION = re.compile(r'extern "C" (int|const char\*) (\w+)\(([^)]*)\)')


def declarations(path) -> dict:
    """Export name → (return type, [parameter type]) of every ``extern "C"``
    definition in the source at ``path``."""
    out = {}
    for ret, name, params in DECLARATION.findall(path.read_text()):
        types = [re.sub(r"\s*\*", "*", p.rsplit(None, 1)[0].strip())
                 for p in " ".join(params.split()).split(",")]
        out[name] = ret, types
    return out


@pytest.mark.parametrize("lib, export", EXPORTS, ids=[e for _, e in EXPORTS])
def test_signature_matches_its_c_declaration(lib, export):
    ret, types = declarations(_build.CSRC / f"{lib.name}.cu")[export]
    assert ret == "int"
    assert [C_TYPES[t] for t in types] == list(lib.signatures[export]), (export, types)


@pytest.mark.parametrize("lib", LIBS, ids=[lib.name for lib in LIBS])
def test_every_export_of_a_source_is_declared_once(lib):
    """Each source's ``extern "C"`` exports are its wrapper's table, and the
    one error-string export is ``csrc/ffi.cuh``'s."""
    assert set(declarations(_build.CSRC / f"{lib.name}.cu")) == set(lib.signatures)
    assert declarations(_build.CSRC / "ffi.cuh") == {"ffi_error_string": ("const char*", ["int"])}
    assert "ffi.cuh" in (_build.CSRC / f"{lib.name}.cu").read_text()


def test_every_source_has_a_table():
    assert {lib.name for lib in LIBS} == {p.stem for p in _build.CSRC.glob("*.cu")}
