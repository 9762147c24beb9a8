"""PS-MMSE channel estimator (the counterpart of
``tpu80211/models/ps_mmse.py``).

Golden-model math (WiFi_channel_estimation_PS_MMSE.m): h = ifft(H_LT),
Rhh = h·hᴴ (rank one); per block, with X4 = diag(tx),
Ryy = X4·F·Rhh·Fᴴ·X4ᴴ + σ²I and H = F·Rhy·pinv(Ryy)·rx; H_MMSE is the mean
of the first 4 block estimates (:26-34).  With v = F·h = H_LT and
u = tx⊙v, Ryy = σ²I + u·uᴴ and H = v·(uᴴ·Ryy⁻¹·rx), so the solvers are:

* "sm": the Sherman-Morrison closed form, no solve (``ps_mmse_sm``);
* "dense": Ryy built and solved by ``torch.linalg.solve`` (the JAX
  package leaves this one to XLA's solve, outside any kernel);
* "dense_pallas": Ryy built and solved by the hand-written solve kernel
  (``kernels/mmse_solve.solve_batched``, complex64), the name the JAX
  package gives its Pallas-kernel solve.

MATLAB mode reproduces the X4-conjugation slip of ..._PS_MMSE.m:30 (Rhy
uses X4, not X4ᴴ).  C-parity mode reproduces main.c:148-212 with its
quirks (SURVEY.md §2.5): the real 'hermitian' (utils.c:6), the addition
bug making Ryy = 2σ²I (utils.c:117), X4 carrying only the 4 pilot entries
(main.c:166-178), and block 0 only.
"""

from __future__ import annotations

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.kernels.mmse_solve import rank1_systems, solve_batched
from tpu80211_torch.ops.linalg import dft_matrix, hermitian_quirk, idft_apply

SOLVERS = ("sm", "dense", "dense_pallas")


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᴴ·b along the last axis."""
    return (a.conj() * b).sum(-1)


def ps_mmse_sm(
    tx_blocks: torch.Tensor,
    rx_blocks: torch.Tensor,
    ow2: torch.Tensor,     # real noise power: (…,) per frame, or 0-d
    h_lt: torch.Tensor,    # (…, 53)
    avg_blocks: int = C.N_AVG_BLOCKS,
    mode: EstimatorMode = EstimatorMode.MATH,
) -> torch.Tensor:
    """Rank-1 (Sherman-Morrison) MMSE.

    Rhh = ifft(H_LT)·ifft(H_LT)ᴴ is rank one, so Ryy = σ²I + u·uᴴ and the
    53×53 inverse reduces to dots; v = F·ifft(H_LT) is exactly H_LT.  MATH
    mode uses the correct X4ᴴ in Rhy; MATLAB mode reproduces the X4 slip
    of ..._PS_MMSE.m:30."""
    tx = tx_blocks[..., :avg_blocks, :]
    rx = rx_blocks[..., :avg_blocks, :]
    vb = h_lt[..., None, :]
    u = tx * vb
    denom = ow2[..., None] + vdot(u, u).real     # (…, avg) real: σ² + ‖u‖²
    urx = vdot(u, rx)
    if mode == EstimatorMode.MATLAB:
        # s = (X4ᴴv)ᴴ·Ryy⁻¹·rx, the general form (cancels as σ² → 0)
        upp = tx.conj() * vb
        s = (vdot(upp, rx) - vdot(upp, u) * urx / denom) / ow2[..., None]
    else:
        # upp = u collapses it to uᴴrx/(σ² + ‖u‖²), stable for any σ² ≥ 0
        s = urx / denom
    return (vb * s[..., None]).mean(dim=-2)


def _ps_mmse_solve(tx_blocks, rx_blocks, ow2, h_lt, avg_blocks, mode, solve):
    """Ryy = σ²I + u·uᴴ built explicitly and solved (the reference's 53×53
    solve per block, main.c:201, ..._PS_MMSE.m:32)."""
    tx = tx_blocks[..., :avg_blocks, :]
    rx = rx_blocks[..., :avg_blocks, :]
    vb = h_lt[..., None, :]
    u = tx * vb
    lead = torch.broadcast_shapes(u.shape[:-1], rx.shape[:-1], ow2[..., None].shape)
    ryy = rank1_systems(u.expand(*lead, C.N_SC), ow2[..., None])
    z = solve(ryy, rx.expand(*lead, C.N_SC)[..., None])[..., 0]   # Ryy⁻¹·rx
    s = vdot(tx.conj() * vb if mode == EstimatorMode.MATLAB else u, z)
    return (vb * s[..., None]).mean(dim=-2)


def ps_mmse(
    tx_blocks: torch.Tensor,  # (…, n_blocks, 53)
    rx_blocks: torch.Tensor,  # (…, n_blocks, 53)
    ow2,                      # σ²: scalar, or per frame (…,) matching h_lt
    h_lt: torch.Tensor,       # (…, 53) LT-LS estimate
    mode: EstimatorMode = EstimatorMode.MATH,
    solver: str = "sm",
    avg_blocks: int = C.N_AVG_BLOCKS,
) -> torch.Tensor:
    """Frame-level MMSE estimate, (…, 53)."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown mmse solver: {solver!r}")
    ow2 = torch.as_tensor(ow2, dtype=h_lt.real.dtype, device=h_lt.device)
    if mode == EstimatorMode.C_PARITY:
        return _ps_mmse_c_parity(tx_blocks, rx_blocks, ow2, h_lt)
    if solver == "sm":
        return ps_mmse_sm(tx_blocks, rx_blocks, ow2, h_lt, avg_blocks=avg_blocks, mode=mode)
    solve = torch.linalg.solve if solver == "dense" else solve_batched
    return _ps_mmse_solve(tx_blocks, rx_blocks, ow2, h_lt, avg_blocks, mode, solve)


def _ps_mmse_c_parity(tx_blocks, rx_blocks, ow2, h_lt):
    """main.c:148-212 with its quirks, block 0 only.  The chain collapses to
    H = F·ifft(H_LT)·⟨w2, rx⟩/(2σ²), where w2 = ((Re − Im)(ifft(H_LT)) @
    hermitian_quirk(F)) ⊙ x4diag and the dot carries no conjugation (the
    reference's 'multiply', utils.c:16-31)."""
    tx = tx_blocks[..., 0, :]
    rx = rx_blocks[..., 0, :]
    t1 = idft_apply(h_lt)                                    # invF·H_LT (main.c:186-187)
    w = (t1.real - t1.imag).to(t1.dtype)                     # hermitian quirk row (utils.c:6)
    fh = hermitian_quirk(torch.as_tensor(dft_matrix()).to(device=t1.device, dtype=t1.dtype))
    mask = torch.zeros(C.N_SC, dtype=t1.real.dtype, device=t1.device)
    mask[list(C.PILOT_IDX)] = 1.0
    w2 = (w @ fh) * (tx * mask)                              # Rhy row factor (main.c:166-192)
    s = (w2 * rx).sum(-1) / (2.0 * ow2)                      # Ryy = 2σ²I (utils.c:117)
    return torch.fft.fft(t1, dim=-1) * s[..., None]          # F·(…) (main.c:203-208)
