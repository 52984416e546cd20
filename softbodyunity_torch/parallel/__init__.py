"""Several devices on one simulation: the row-sharded grid cloth
(:mod:`.halo`) over a ring of ranks (:mod:`.ring`), a ``torch.distributed``
process group or threads of one process."""

from .halo import (HALO, ROWS_AXIS, make_halo_step, make_halo_verlet_step,
                   make_halo_xpbd_step, pack_capsule_box_geometry,
                   shard_grid_state, tear_plane_shard_maps, unshard_to_state)
from .ring import DistRing, LocalRing

__all__ = ["HALO", "ROWS_AXIS", "DistRing", "LocalRing", "make_halo_step",
           "make_halo_verlet_step", "make_halo_xpbd_step",
           "pack_capsule_box_geometry", "shard_grid_state",
           "tear_plane_shard_maps", "unshard_to_state"]
