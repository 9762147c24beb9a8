"""The port's figures (``tpu80211_torch/utils/plots.py`` and ``cli plot``)
against the JAX package's, on the CPU: the same file names, non-empty
PNGs; and without matplotlib an ImportError that names it, never a figure
skipped quietly."""

import sys

import numpy as np
import pytest
import torch

from tpu80211 import cli as jcli
from tpu80211.utils import plots as jplots
from tpu80211_torch import cli
from tpu80211_torch.utils import plots

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _estimates():
    rng = np.random.default_rng(0)
    h = rng.standard_normal(53) + 1j * rng.standard_normal(53)
    return {"LT-LS": h, "PS-linear": torch.tensor(h * 0.9)}


def _is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_MAGIC and len(f.read()) > 1000


def test_plot_cfr_writes_the_jax_file_names(tmp_path):
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    got = plots.plot_cfr(_estimates(), str(tmp_path / "port" / "cfr"), title="t")
    want = jplots.plot_cfr({k: np.asarray(v) for k, v in _estimates().items()},
                           str(tmp_path / "jax" / "cfr"), title="t")
    assert [p.replace("/port/", "/") for p in got] == [p.replace("/jax/", "/") for p in want]
    assert all(_is_png(p) for p in got)


def test_plot_constellation_writes_a_png(tmp_path):
    rng = np.random.default_rng(1)
    sym = torch.complex(*(torch.tensor(rng.standard_normal(500)) for _ in range(2)))
    qpsk = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2.0)
    path = str(tmp_path / "const.png")
    assert plots.plot_constellation({"a": sym, "b": sym.numpy() * 0.5}, path, qpsk) == path
    want = jplots.plot_constellation({"a": sym.numpy()}, str(tmp_path / "jconst.png"), qpsk)
    assert _is_png(path) and _is_png(want)


def test_cli_plot_writes_the_jax_commands_paths(tmp_path, capsys):
    assert cli.main(["plot", "--device", "cpu", "--out-prefix", str(tmp_path / "port" / "cfr")]) == 0
    got = capsys.readouterr().out.split()
    assert jcli.main(["plot", "--out-prefix", str(tmp_path / "jax" / "cfr")]) == 0
    want = capsys.readouterr().out.split()
    assert len(got) == 4
    assert [p.replace("/port/", "/") for p in got] == [p.replace("/jax/", "/") for p in want]
    assert all(_is_png(p) for p in got)


@pytest.mark.parametrize("fn", ["plot_cfr", "plot_constellation"])
def test_missing_matplotlib_raises(fn, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    args = ((_estimates(), str(tmp_path / "x")) if fn == "plot_cfr"
            else ({"a": np.ones(4, complex)}, str(tmp_path / "x.png")))
    with pytest.raises(ImportError, match=f"{fn} needs matplotlib"):
        getattr(plots, fn)(*args)
    assert not list(tmp_path.iterdir())


def test_cli_commands_that_plot_raise_without_matplotlib(tmp_path, monkeypatch):
    """``plot`` and ``sync --constellation`` raise without matplotlib;
    ``sync`` without a figure does not need it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(["plot", "--device", "cpu", "--out-prefix", str(tmp_path / "cfr")])
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(["sync", "--device", "cpu", "--batch", "8",
                  "--constellation", str(tmp_path / "c.png")])
    assert cli.main(["sync", "--device", "cpu", "--batch", "8"]) == 0
