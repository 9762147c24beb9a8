"""The dense MMSE solves on the card: correctness, then solves/s (the port
of ``scripts/bench_mmse_solve.py``).

    python -m tpu80211_torch.bench.mmse_solve               # B=8,192 systems, n=32, gauss and chol
    python -m tpu80211_torch.bench.mmse_solve --methods gauss,chol,xla,xla_chol
    python -m tpu80211_torch.bench.mmse_solve --device cpu 256 2   # a rehearsal

Correctness (the script's assert, before timing): 128 systems σ²I + u·uᴴ
(numpy seed 0, σ² = 0.37) through ``kernels.mmse_solve.fused_rank1_solve``,
every 17th against ``np.linalg.solve`` in float64, rel < 5e-5.

Throughput (`METHODS`): ``gauss`` and ``chol`` through the fused solve
kernel on B systems of standard normal u and rx; the library rows
(`LIBRARY`, on request) solve the same systems materialized as (B, 53, 53)
complex64 each step, by ``torch.linalg.solve`` (``xla``) and by
``torch.linalg.cholesky`` with two ``solve_triangular`` (``xla_chol``).
Step i solves with σ² = 0.37·(1 + 1e-6·i).
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.kernels import mmse_solve as MS

BATCH, ITERS = 8192, 32
N = 53
SIGMA2 = 0.37
CHECK_SYSTEMS, CHECK_EVERY = 128, 17   # the script's LANES systems, every 17th checked
TOL = 5e-5
METHODS = ("gauss", "chol")
LIBRARY = ("xla", "xla_chol")


def correctness(method: str, dev) -> float:
    """The largest relative error of the checked systems against numpy."""
    rng = np.random.default_rng(0)
    b = CHECK_SYSTEMS
    u = rng.standard_normal((b, N)) + 1j * rng.standard_normal((b, N))
    rx = rng.standard_normal((b, N)) + 1j * rng.standard_normal((b, N))
    ow2 = np.full((b,), SIGMA2, np.float32)
    got = MS.fused_rank1_solve(*(torch.tensor(v, dtype=torch.complex64, device=dev)
                                 for v in (u, rx)), torch.tensor(ow2, device=dev), method)
    got = got.cpu().numpy()
    rel = 0.0
    for i in range(0, b, CHECK_EVERY):
        a = ow2[i] * np.eye(N) + np.outer(u[i], np.conj(u[i]))
        want = np.linalg.solve(a, rx[i])
        rel = max(rel, float(np.abs(got[i] - want).max() / np.abs(want).max()))
    return rel


def library_solve(method: str, u: torch.Tensor, rx: torch.Tensor, ow2: torch.Tensor):
    """The library's solve of σ²I + u·uᴴ, materialized (the script's ``xla``
    and ``xla_chol`` steps)."""
    eye = torch.eye(N, dtype=u.dtype, device=u.device)
    a = ow2[:, None, None] * eye + u[:, :, None] * u.conj()[:, None, :]
    if method == "xla":
        return torch.linalg.solve(a, rx[..., None])[..., 0]
    low = torch.linalg.cholesky(a)
    y = torch.linalg.solve_triangular(low, rx[..., None], upper=False)
    return torch.linalg.solve_triangular(low.mH, y, upper=True)[..., 0]


def solve_case(method: str, batch: int, iters: int, dev, gates: dict) -> TP.Case:
    """The method's steps at B and B/2 (`throughput.solve_steps`)."""
    solve = (functools.partial(library_solve, method) if method in LIBRARY
             else lambda *a: MS.fused_rank1_solve(*a, method))
    step, half, _, _ = TP.solve_steps(solve, batch, iters, dev, seed=0)
    return TP.Case(gates, step, half)


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("mmse_solve", __doc__)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH, help=f"B (default {BATCH})")
    ap.add_argument("iters", nargs="?", type=int, default=ITERS,
                    help=f"the loop length n (default {ITERS})")
    ap.add_argument("--methods", default=",".join(METHODS),
                    help=f"comma-separated, of {', '.join(METHODS + LIBRARY)} (default %(default)s)")
    args = ap.parse_args(argv)
    methods = args.methods.split(",")
    unknown = set(methods) - set(METHODS + LIBRARY)
    if unknown:
        ap.error(f"unknown methods {sorted(unknown)}")
    dev = CM.open_device(args.device, "mmse_solve", ("mmse_solve",))
    if dev is None:
        return 1
    doc = {"device": TP.device_name(dev)}
    for method in methods:
        gates = {}
        if method in METHODS:
            rel = correctness(method, dev)
            doc[f"{method}_rel_err"] = gates["rel_err"] = rel
            TP.gate(method, rel < TOL, gates, f"a system off numpy's f64 solve by {TOL} or more")
        m = TP.measure(solve_case(method, args.batch, args.iters, dev, gates), args.batch,
                       args.iters, dev)
        doc[method] = {"method": method, "solves_per_s": m["per_s"],
                       "ms_per_step": m["loop_ms"]["host"], "batch": args.batch,
                       "wall_s_single_loop": CM.single_s(m), "gates": gates, **CM.fences(m)}
        CM.emit({k: v for k, v in doc[method].items() if k not in ("marginals_s", "single_s")})
    last = {
        "metric": "dense MMSE solves/s, gated, loop-length marginal (host)",
        "device": doc["device"], "batch": args.batch, "iters": args.iters,
        "rel_err": {k: TP.rounded(doc[f"{k}_rel_err"], 2) for k in methods if k in METHODS},
        "rows": {k: {"solves_per_s": round(doc[k]["solves_per_s"]), **CM.short(doc[k])}
                 for k in methods},
    }
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
