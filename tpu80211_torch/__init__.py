"""tpu80211_torch — the 802.11 OFDM receive chain in PyTorch and CUDA.

The PyTorch counterpart of ``tpu80211``, module for module: plain tensor
code runs in ``torch`` (complex dtypes, explicit ``device=``/``dtype=``),
and every Pallas kernel of ``tpu80211/kernels`` becomes a kernel written by
hand for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.  On a
CPU tensor a kernel wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.  Nothing here imports JAX.
"""

from tpu80211_torch import constants
from tpu80211_torch.config import Config, EstimatorMode

__version__ = "0.1.0"

__all__ = ["constants", "Config", "EstimatorMode", "__version__"]
