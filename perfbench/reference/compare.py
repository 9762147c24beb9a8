"""The comparison that decides ``correct``: the program's outputs against the
plain reference's, on the same inputs, as a few numbers each held to a limit.

* ``h_rel``: over every h plane that the call returns, the largest of
  max|h − h_ref| / max|h_ref| (each plane over all frames compared);
* ``eq_ulp``: the largest |eq − eq_ref| of one equalized symbol, in steps
  (ulps) of eq's storage type at the larger part (re or im) of the
  reference's symbol: one wrong symbol anywhere shows;
* ``ow2_rel``: the largest |σ² − σ²_ref| / σ²_ref of a frame (the front end);
* ``cfo_abs``: the largest |cfo − cfo_ref| of a frame, cycles per sample;
* ``det_miss`` (raw streams): the streams whose detection or start differs.
  The chain's numbers cover the other streams.

Everything in float64.  A NaN anywhere makes its number NaN, which no limit
holds.
"""

from __future__ import annotations

import math

import torch


class Numbers:
    """Accumulates the numbers over blocks of frames."""

    def __init__(self):
        self.h_err: dict[str, float] = {}
        self.h_ref: dict[str, float] = {}
        self.eq_ulp = 0.0
        self.ow2_rel = 0.0
        self.cfo_abs = 0.0
        self.det_miss = None
        self.frames = 0

    @staticmethod
    def _c(pair) -> torch.Tensor:
        return torch.complex(pair[0].to(torch.float64), pair[1].to(torch.float64))

    @staticmethod
    def _max(x: torch.Tensor) -> float:
        v = float(x.max()) if x.numel() else 0.0
        return math.nan if bool(torch.isnan(x).any()) else v

    def add(self, got: dict, want: dict, planes, keep: torch.Tensor | None = None) -> None:
        """One block: ``got`` and ``want`` map names to (re, im) planes with
        the frame axis last (``ow2``, ``cfo`` to (B,) tensors); ``planes``
        names the h planes to hold; ``keep`` (B,) bool selects frames."""
        def cut(t):
            return t if keep is None else t[..., keep]

        for name in planes:
            g, w = cut(self._c(got[name])), cut(self._c(want[name]))
            self.h_err[name] = max(self.h_err.get(name, 0.0), self._max((g - w).abs()))
            self.h_ref[name] = max(self.h_ref.get(name, 0.0), self._max(w.abs()))
        g, w = cut(self._c(got["eq"])), cut(self._c(want["eq"]))
        step = ulp(torch.maximum(cut(want["eq"][0]).abs(), cut(want["eq"][1]).abs()))
        self.eq_ulp = max(self.eq_ulp, self._max((g - w).abs() / step))
        g, w = cut(got["ow2"].to(torch.float64)), cut(want["ow2"].to(torch.float64))
        self.ow2_rel = max(self.ow2_rel, self._max((g - w).abs() / w.abs()))
        g, w = cut(got["cfo"].to(torch.float64)), cut(want["cfo"].to(torch.float64))
        self.cfo_abs = max(self.cfo_abs, self._max((g - w).abs()))
        self.frames += int(w.numel())

    def add_detection(self, got: dict, want: dict) -> torch.Tensor:
        """Counts the streams whose detection differs; returns the (B,) mask
        of those that agree."""
        agree = (got["detected"].cpu() == want["detected"].cpu()) & (
            got["start"].cpu().to(torch.int64) == want["start"].cpu().to(torch.int64))
        self.det_miss = (self.det_miss or 0) + int((~agree).sum())
        return agree

    def result(self) -> dict:
        h = max((self.h_err[k] / self.h_ref[k] if self.h_ref[k] > 0 else math.nan)
                for k in self.h_err) if self.h_err else math.nan
        out = {"h_rel": h, "eq_ulp": self.eq_ulp,
               "ow2_rel": self.ow2_rel, "cfo_abs": self.cfo_abs}
        if self.det_miss is not None:
            out["det_miss"] = float(self.det_miss)
        return out


def ulp(x: torch.Tensor) -> torch.Tensor:
    """The step of ``x``'s floating type at each value of ``x`` (float64;
    the smallest normal's step at 0)."""
    fi = torch.finfo(x.dtype)
    _, e = torch.frexp(x.to(torch.float64).abs().clamp_min(fi.tiny))
    return torch.ldexp(torch.full_like(e, fi.eps / 2, dtype=torch.float64), e)


def holds(value: float, limit: float) -> bool:
    """A number holds its limit when it is not NaN and at most the limit."""
    return value == value and value <= limit
