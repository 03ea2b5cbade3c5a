"""The sharding layer of one process: device meshes, halo exchange and
sharded ops.

Counterpart of ``baseband_tasks_tpu/parallel`` (without ``multihost``):
a mesh is a named grid of ``torch.device`` (:func:`make_mesh`), driven by
one process as JAX's single controller drives a ``Mesh`` through
``shard_map``; the collectives become copies between the shards' devices
(:func:`ppermute`, :func:`all_to_all`).  Time-axis sharding moves
overlap-save halos between neighbours (:func:`halo_edges`, or in one
kernel, :func:`halo_edges_remote`); channel sharding needs no
communication; profiles are summed over time shards.
"""

from .mesh import (Mesh, default_devices, make_mesh, shard, time_chan_specs,
                   unshard)
from .halo import halo_edges, halo_exchange, ppermute, sharded_overlap_save
from .halo_remote import (halo_edges_remote, halo_edges_remote_ref,
                          halo_exchange_remote, mesh_logical_id)
from .corner import (all_to_all, corner_turn, sharded_channelize,
                     sharded_dechannelize)

__all__ = ["Mesh", "make_mesh", "default_devices", "time_chan_specs",
           "shard", "unshard", "halo_exchange", "halo_edges", "ppermute",
           "halo_edges_remote", "halo_edges_remote_ref",
           "halo_exchange_remote", "mesh_logical_id", "sharded_overlap_save",
           "corner_turn", "all_to_all", "sharded_channelize",
           "sharded_dechannelize"]
