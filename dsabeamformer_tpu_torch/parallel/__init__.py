"""Scale-out over several devices, or several slots of one device.

Two axes, composable on a 2-D ``(chan, ant)`` mesh
(``sharding.Mesh``, slots are ``torch.device``s and may repeat):

- **Channel sharding** (sharding.py): the reference scaled out with one
  process per GPU on a disjoint 256-channel subband and no traffic between
  them.  One process drives a ``("chan",)`` mesh: every slot runs the
  single-device detect kernel on its subband, the products are gathered by
  channel, and the only reduction is the optional band total power.
  ``multihost.py`` runs one such mesh per process under
  ``torch.distributed``, each on its own subband; the band power is its one
  collective.
- **Antenna (tensor-parallel) sharding** (tensor.py): the K-split
  contraction, each slot's partial beam voltages (the voltage kernel)
  summed over the antenna axis before detection, for arrays whose
  per-channel GEMM outgrows one device.  No reference counterpart.
"""

from dsabeamformer_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_weights,
    sharded_beamformer,
    sharded_wire_sharding,
)
from dsabeamformer_tpu_torch.parallel.tensor import (
    make_tp_mesh,
    shard_weights_tp,
    tp_beamformer,
    tp_wire_sharding,
)

__all__ = [
    "make_mesh",
    "shard_weights",
    "sharded_beamformer",
    "sharded_wire_sharding",
    "make_tp_mesh",
    "shard_weights_tp",
    "tp_beamformer",
    "tp_wire_sharding",
]
