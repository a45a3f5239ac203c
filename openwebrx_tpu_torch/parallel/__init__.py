"""Multi-device scaling: meshes of ranks, channel sharding, halo exchange.

Counterpart of ``openwebrx_tpu/parallel/`` on ``torch.distributed``, one
process (rank) per device:

- **channel sharding**: the bank's channel axis is split over the ranks;
  each demodulates its slice of listeners (``pod.py``);
- **time-block sharding + halo exchange**: wideband IQ is split along time
  across ranks; streaming FIR state becomes a ring of boundary samples
  (``halo.py``);
- **frequency-slab sharding**: the polyphase channelizer's output is
  re-sharded from time slices to channel slices by one all_to_all
  (``pfb.py``); ``cluster.py`` joins the ranks of several hosts.
"""

from openwebrx_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
