"""Entry points of the port: the chain with example inputs, and the
multi-device dry run (the counterparts of the root ``__graft_entry__.py``).

    python -c "from tpu80211_torch import entry; entry.dryrun_multichip(2)"
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets import synthetic
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.ops.detect import lts_time_symbol
from tpu80211_torch.parallel import launch, multihost
from tpu80211_torch.parallel.mesh import (frame_sharding, make_mesh, pad_blocks,
                                          rx_step_shardmap, shard_batch, shard_blocks)
from tpu80211_torch.pipeline import sc, stream


def entry(device="cuda"):
    """(fn, example_args): the full receive chain ``sc.rx_chain`` and 64
    frames of normal complex64 samples on ``device`` (tx packet, rx packet,
    tx long preamble, rx long preamble)."""
    rng = np.random.default_rng(0)

    def c(shape):
        re, im = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for _ in range(2))
        return torch.complex(re, im).to(device)

    batch = 64
    return sc.rx_chain, (c((batch, C.PACKET_SAMPLES)), c((batch, C.PACKET_SAMPLES)),
                         c((batch, C.PREAMBLE_SAMPLES)), c((batch, C.PREAMBLE_SAMPLES)))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the multi-device layer once in an ``n_devices``-rank world
    (`parallel.launch`); raises if a check fails.  Rank r takes card
    r mod (cards present) with NCCL when every rank has its own card, gloo
    otherwise; ``device="cpu"`` runs every rank on the CPU (gloo).  The
    checks, on every rank:

    1. the explicit-collective step `rx_step_shardmap` over (dp, blk), blk 2
       when n is even and at least 4: its rows, a finite global metric;
    2. the ('host', 'dp', 'blk') mesh of `multihost.hierarchical_mesh`:
       ``sc.rx_chain_freq`` on the rank's rows;
    3. the mesh ``kernel`` stream step: 128 frames a rank, a finite NMSE;
    4. the raw receiver on the rank's share of 128·n streams: every stream
       detected, start − offset within [−4, −2];
    5. the mesh ``kernel_raw`` stream step: every stream detected."""
    dev = torch.device(device)
    backend = None if dev.type == "cpu" or torch.cuda.device_count() >= n_devices else "gloo"
    launch.launch(_dryrun_rank, n_devices, n_devices, device, device=device, backend=backend)


def _dryrun_rank(n: int, device) -> None:
    dev = multihost.rank_device(device)
    blk = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // blk
    mesh = make_mesh(dp=dp, blk=blk, device=device)
    batch = 2 * dp   # two frames a dp shard
    fb = synthetic.generate(torch.Generator().manual_seed(0), batch)
    step, nb_pad = rx_step_shardmap(mesh)
    pre = shard_batch(mesh, (fb.tx_preamble_fft, fb.rx_preamble_fft, fb.ow2), dev)
    blocks = shard_blocks(mesh, (pad_blocks(fb.tx_symb, blk)[:, :nb_pad],
                                 pad_blocks(fb.rx_symb, blk)[:, :nb_pad]), dev)
    out, mse = step(pre[0], pre[1], *blocks, pre[2])
    _check(tuple(out.h_mmse.shape) == (2, C.N_SC), f"shardmap h_mmse {tuple(out.h_mmse.shape)}")
    _check(math.isfinite(float(mse)), f"shardmap metric {float(mse)}")

    hmesh = multihost.hierarchical_mesh(blk=1, device=device)
    batch2 = 2 * n
    fb2 = synthetic.generate(torch.Generator().manual_seed(1), batch2)
    rows = multihost.frame_sharding_mh(hmesh, batch2)
    out2 = sc.rx_chain_freq(*(x[rows].to(dev) for x in (
        fb2.tx_preamble_fft, fb2.rx_preamble_fft, fb2.tx_symb, fb2.rx_symb, fb2.ow2)))
    _check(tuple(out2.h_mmse.shape) == (2, C.N_SC), f"hierarchical h_mmse {tuple(out2.h_mmse.shape)}")

    smesh = make_mesh(dp=n, blk=1, device=device)
    sstep, s0 = stream.make_device_stream_step(128 * n, snr_db=35.0, mesh=smesh, device=dev)
    summary, _, _ = sstep(0, s0)
    _check(math.isfinite(float(summary["h_mmse_nmse"])), f"kernel stream {summary}")

    cap = load_capture()
    rng = np.random.default_rng(2)
    ns, rb = 2048, 128 * n
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    xs = (rng.standard_normal((rb, ns)) + 1j * rng.standard_normal((rb, ns))) * 1e-4
    offs = rng.integers(40, ns - 1400, rb)
    for i, o in enumerate(offs):
        xs[i, o:o + frame.size] += frame
    mine = frame_sharding(smesh, rb)

    def planes(x) -> Cplx:
        x = np.asarray(x)
        return Cplx(*(torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=dev)
                      for v in (x.real, x.imag)))

    txs, tpre = F.tx_spectra(planes(cap.tx_packet), planes(cap.tx_lptot))
    rout = R.raw_rx_txconst_fused(planes(xs[mine].T), planes(lts_time_symbol(cap.tx_lptot).numpy()),
                                  txs, tpre)
    _check(bool(rout["detected"].all()), "raw receiver: a stream went undetected")
    err = rout["start"].cpu().numpy() - offs[mine]
    _check(err.min() >= -4 and err.max() <= -2, f"raw receiver timing {err.min()}..{err.max()}")

    rstep, r0 = stream.make_device_stream_step(128 * n, snr_db=30.0, gen="kernel_raw",
                                               mesh=smesh, device=dev)
    rsum, _, _ = rstep(0, r0)
    _check(float(rsum["detect_rate"]) == 1.0, f"kernel_raw stream detect_rate {rsum}")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")
