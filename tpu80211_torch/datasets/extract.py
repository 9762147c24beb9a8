"""Extract the frozen parity capture from the reference sources into .npz
(the counterpart of ``tpu80211/datasets/extract.py``: the same parsers).

The reference ships the same captured 802.11 frame twice: frequency-domain
tables in ``inputs.h`` (tx/rx_preamble_fft[53], tx/rx_symb[795], OW2 —
inputs.h:18,20,75,130,928) used by the C programs, and time-domain tables in
``WiFi_inputs.m`` (tx/rx_packet[1200], tx/rx_lptot[160] — WiFi_inputs.m:4,
1208,2412,2575) used by the MATLAB chain.  Both numeric tables (data, not
code) are parsed into one ``.npz`` that ``datasets.loader.load_capture``
reads:

    python -m tpu80211_torch.datasets.extract REFERENCE_DIR OUT.npz

Both paths are required: the shipped capture lives in the JAX package's
data directory, and this module never writes there.
"""

from __future__ import annotations

import argparse
import pathlib
import re

import numpy as np

_C_COMPLEX = re.compile(
    r"([+-]?\d+\.?\d*(?:[eE][+-]?\d+)?)\s*([+-])\s*(\d+\.?\d*(?:[eE][+-]?\d+)?)\s*\*\s*I"
)
_M_COMPLEX = re.compile(
    r"([+-]?\d+\.?\d*(?:[eE][+-]?\d+)?)\s*([+-])\s*(\d+\.?\d*(?:[eE][+-]?\d+)?)i"
)


def _parse_complex_table(text: str, pattern: re.Pattern) -> np.ndarray:
    vals = [complex(float(re_), float(sign + im)) for re_, sign, im in pattern.findall(text)]
    return np.asarray(vals, dtype=np.complex128)


def _slice_between(text: str, start: str, end: str) -> str:
    i = text.index(start)
    j = text.index(end, i + len(start))
    return text[i:j]


def extract_inputs_h(path: pathlib.Path) -> dict:
    """``inputs.h`` → {tx_preamble_fft (53,), rx_preamble_fft, tx_symb
    (795,), rx_symb, ow2}, complex128 and float64."""
    text = pathlib.Path(path).read_text()
    ow2 = float(re.search(r"OW2\s*=\s*([\d.eE+-]+)\s*;", text).group(1))
    sections = {}
    names = ["tx_preamble_fft", "rx_preamble_fft", "tx_symb", "rx_symb"]
    markers = [f"{n}[" for n in names]
    for k, name in enumerate(names):
        seg = (_slice_between(text, markers[k], markers[k + 1]) if k + 1 < len(names)
               else text[text.index(markers[k]):])
        sections[name] = _parse_complex_table(seg, _C_COMPLEX)
    assert sections["tx_preamble_fft"].shape == (53,)
    assert sections["rx_preamble_fft"].shape == (53,)
    assert sections["tx_symb"].shape == (795,)
    assert sections["rx_symb"].shape == (795,)
    sections["ow2"] = np.float64(ow2)
    return sections


def extract_wifi_inputs_m(path: pathlib.Path) -> dict:
    """``WiFi_inputs.m`` → {rx_packet (1200,), tx_packet, tx_lptot (160,),
    rx_lptot}, complex128."""
    text = pathlib.Path(path).read_text()
    names = ["rx_packet", "tx_packet", "tx_lptot", "rx_lptot"]
    shapes = {"rx_packet": 1200, "tx_packet": 1200, "tx_lptot": 160, "rx_lptot": 160}
    out = {}
    # anchor on the assignments, not the function-signature mentions
    starts = {n: re.search(rf"{n}\s*=\s*\[", text).start() for n in names}
    order = sorted(names, key=starts.get)
    bounds = {n: starts[order[i + 1]] if i + 1 < len(order) else len(text)
              for i, n in enumerate(order)}
    for name in names:
        arr = _parse_complex_table(text[starts[name]:bounds[name]], _M_COMPLEX)
        assert arr.shape == (shapes[name],), (name, arr.shape)
        out[name] = arr
    return out


def extract(reference_dir: str | pathlib.Path, out_path: str | pathlib.Path) -> dict:
    """Parse ``reference_dir``'s ``inputs.h`` and ``WiFi_inputs.m`` and
    write their tables to ``out_path`` (compressed npz); returns them."""
    ref = pathlib.Path(reference_dir)
    data = extract_inputs_h(ref / "inputs.h")
    data.update(extract_wifi_inputs_m(ref / "WiFi_inputs.m"))
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **data)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu80211_torch.datasets.extract",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("reference_dir", help="directory holding inputs.h and WiFi_inputs.m")
    ap.add_argument("out", help="the .npz to write")
    args = ap.parse_args(argv)
    data = extract(args.reference_dir, args.out)
    print(f"wrote {args.out}: "
          + ", ".join(f"{k}{getattr(v, 'shape', '')}" for k, v in data.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
