"""The port's capture extractor (``tpu80211_torch/datasets/extract.py``)
against the shipped capture and the JAX package's extractor, on the CPU.

The reference sources are not in the repository, so each test writes an
``inputs.h`` and a ``WiFi_inputs.m`` holding the capture's values (printed
with ``repr``, which round-trips every float64) in the two formats the
parsers read: ``a + b*I`` (C99) and ``a + bi`` (MATLAB).
"""

import numpy as np
import pytest

from tpu80211.datasets import extract as jextract
from tpu80211_torch.datasets import extract
from tpu80211_torch.datasets.loader import _DATA, load_capture

H_NAMES = ("tx_preamble_fft", "rx_preamble_fft", "tx_symb", "rx_symb")
M_NAMES = ("rx_packet", "tx_packet", "tx_lptot", "rx_lptot")   # WiFi_inputs.m's order


def _num(z: complex, imag_unit: str) -> str:
    sign = "-" if np.signbit(z.imag) else "+"
    return f"{z.real!r} {sign} {abs(z.imag)!r}{imag_unit}"


def _table(values, imag_unit: str, per_line: int = 4) -> str:
    items = [_num(complex(z), imag_unit) for z in values]
    return ",\n".join("    " + ", ".join(items[i:i + per_line])
                      for i in range(0, len(items), per_line))


@pytest.fixture(scope="module")
def npz():
    with np.load(_DATA) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory, npz):
    ref = tmp_path_factory.mktemp("reference")
    h = ["/* inputs.h: the captured frame, frequency domain */", "#include <complex.h>",
         f"const long double OW2 = {float(npz['ow2'])!r};", ""]
    for name in H_NAMES:
        h += [f"long double complex {name}[{npz[name].size}] = {{",
              _table(npz[name], "*I"), "};", ""]
    (ref / "inputs.h").write_text("\n".join(h))
    m = ["function [rx_packet, tx_packet, tx_lptot, rx_lptot] = WiFi_inputs()",
         "% the captured frame, time domain", ""]
    for name in M_NAMES:
        m += [f"{name} = [", _table(npz[name], "i").replace(",\n", " ...\n"), "];", ""]
    (ref / "WiFi_inputs.m").write_text("\n".join(m))
    return ref


def _bit_equal(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_inputs_h_parser_returns_the_capture_bit_for_bit(reference_dir, npz):
    got = extract.extract_inputs_h(reference_dir / "inputs.h")
    assert set(got) == {*H_NAMES, "ow2"}
    for name in H_NAMES:
        _bit_equal(got[name], npz[name])
    assert got["ow2"] == npz["ow2"] and isinstance(got["ow2"], np.float64)


def test_wifi_inputs_m_parser_returns_the_capture_bit_for_bit(reference_dir, npz):
    got = extract.extract_wifi_inputs_m(reference_dir / "WiFi_inputs.m")
    assert set(got) == set(M_NAMES)
    for name in M_NAMES:
        _bit_equal(got[name], npz[name])


def test_parsers_equal_the_jax_parsers(reference_dir):
    for fn, jfn, name in ((extract.extract_inputs_h, jextract.extract_inputs_h, "inputs.h"),
                          (extract.extract_wifi_inputs_m, jextract.extract_wifi_inputs_m,
                           "WiFi_inputs.m")):
        got, want = fn(reference_dir / name), jfn(reference_dir / name)
        assert set(got) == set(want)
        for k in want:
            _bit_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_extract_writes_what_load_capture_reads(reference_dir, tmp_path):
    out = tmp_path / "sub" / "capture.npz"
    data = extract.extract(reference_dir, out)
    assert set(data) == {*H_NAMES, *M_NAMES, "ow2"}
    got, want = load_capture(out), load_capture()
    for field in ("tx_preamble_fft", "rx_preamble_fft", "tx_symb", "rx_symb",
                  "tx_packet", "rx_packet", "tx_lptot", "rx_lptot"):
        _bit_equal(getattr(got, field), getattr(want, field))
    assert got.ow2 == want.ow2


def test_main_takes_both_paths(reference_dir, tmp_path, capsys):
    """``main`` writes where it is told and needs both paths: it has no
    default that could write into the JAX package's data directory."""
    out = tmp_path / "main.npz"
    assert extract.main([str(reference_dir), str(out)]) == 0
    assert out.exists() and "wrote" in capsys.readouterr().out
    for argv in ([], [str(reference_dir)]):
        with pytest.raises(SystemExit) as e:
            extract.main(argv)
        assert e.value.code == 2


def test_parsers_reject_a_short_table(reference_dir, tmp_path):
    text = (reference_dir / "inputs.h").read_text()
    cut = text.replace(_num(complex(np.load(_DATA)["rx_symb"][-1]), "*I"), "")
    (tmp_path / "inputs.h").write_text(cut)
    with pytest.raises(AssertionError):
        extract.extract_inputs_h(tmp_path / "inputs.h")
