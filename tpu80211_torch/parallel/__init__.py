"""The multi-device layer on ``torch.distributed``, one process per device
(the counterpart of ``tpu80211/parallel``): the mesh and its receive steps
(``mesh``), worlds and hierarchical meshes (``multihost``), and an n-rank
world on one host (``launch``)."""

from tpu80211_torch.parallel.mesh import (
    BLK,
    DP,
    frame_sharding,
    make_mesh,
    pad_blocks,
    rx_chain_dp,
    rx_step_shardmap,
    shard_batch,
)

__all__ = [
    "DP",
    "BLK",
    "make_mesh",
    "frame_sharding",
    "shard_batch",
    "rx_chain_dp",
    "rx_step_shardmap",
    "pad_blocks",
]
