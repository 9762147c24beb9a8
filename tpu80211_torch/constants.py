"""Problem constants of the 802.11 estimation study.

Mirrors the reference's compile-time defines (``utils.h:10-19``,
``inputs.h:6-14``) and the MATLAB parameters (``WiFi_RX.m:4-14``) as plain
Python constants.  These are *problem* constants — the frame geometry of the
captured dataset — not tunables.
"""

import numpy as np

# -- OFDM geometry (utils.h:12-15, WiFi_RX.m:11-14) -------------------------
N_SC = 53            # used subcarriers incl. DC ("SAMPUTIL")
N_BLOCKS = 15        # OFDM data symbols per frame ("OFDMBLK")
N_FFT = 64           # FFT size ("K")
N_CP = 16            # cyclic-prefix samples
SAMP_PER_BLOCK = N_FFT + N_CP          # 80 ("sampXblock")
FRAME_SYMBOLS = N_SC * N_BLOCKS        # 795 ("SIZESYMBOL")
PACKET_SAMPLES = SAMP_PER_BLOCK * N_BLOCKS   # 1200 time-domain samples
PREAMBLE_SAMPLES = 160                 # two 64-sample LTS repeats + CP

# fftshift amount used by the MATLAB chain: circshift(fft(x,64),26) then
# truncate to 53 (WiFi_RX.m:22-29, WiFi_blocks_extraction.m:7-9)
FFT_SHIFT = 26

# -- pilot layout (utils.h:16-19; MATLAB 1-based 6/20/34/48) -----------------
PILOT_IDX = (5, 19, 33, 47)   # 0-based pilot subcarrier indices
N_PILOTS = 4
PILOT_DELTA = 14              # uniform pilot spacing P1-P0
DC_IDX = 26                   # DC subcarrier (index 26 of 53)

# blocks averaged into the final pilot-based estimate
# (WiFi_channel_estimation_PS_Linear.m:23 — blocks 1..4, i.e. first 4)
N_AVG_BLOCKS = 4

# -- measured noise power of the shipped capture (inputs.h:18) ---------------
OW2 = 9.6172e-08

# -- TPU-friendly padded sizes ------------------------------------------------
# 53 is awkward for the 8x128 VPU / 128x128 MXU; all padded kernels use 64.
N_SC_PAD = 64

PILOT_MASK = np.zeros((N_SC,), dtype=bool)
PILOT_MASK[list(PILOT_IDX)] = True

DATA_MASK = ~PILOT_MASK.copy()
DATA_MASK[DC_IDX] = False
