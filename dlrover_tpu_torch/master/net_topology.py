"""Rank assignment by physical topology.

Copy of ``dlrover_tpu/master/net_topology.py``, its imports the port's.

The JAX package's counterpart of DLRover's ``master/elastic_training/net_topology.py:56-82``
(``DpTopologySorter``): the reference sorts ranks so nodes under one access
switch are contiguous in the DP ring.  On TPU the analogue is: hosts of the
same pod slice (one ICI domain) must get contiguous ranks so that mesh axes
laid out over contiguous process ranks keep heavy collectives on ICI and
only cross DCN at slice boundaries.  Slice identity comes from the platform
(GKE topology labels / TPU metadata), carried in ``NodeMeta``.
"""

from typing import Dict, List

from dlrover_tpu_torch.common.comm import NodeMeta


class TopologySorter:
    def sort(self, nodes: List[NodeMeta]) -> Dict[int, NodeMeta]:
        raise NotImplementedError


class SliceContiguousSorter(TopologySorter):
    """Sort hosts so each TPU slice's hosts are rank-contiguous.

    Order: (topology_label, slice_id, original node_rank).  Returns a dict
    rank -> NodeMeta with ``node_rank`` rewritten to the assigned rank.
    """

    def sort(self, nodes: List[NodeMeta]) -> Dict[int, NodeMeta]:
        ordered = sorted(
            nodes,
            key=lambda n: (n.topology_label, n.slice_id, n.node_rank, n.node_id),
        )
        world: Dict[int, NodeMeta] = {}
        for rank, meta in enumerate(ordered):
            meta.node_rank = rank
            world[rank] = meta
        return world


class DefaultSorter(TopologySorter):
    """Stable sort by requested node_rank then node_id (no topology info)."""

    def sort(self, nodes: List[NodeMeta]) -> Dict[int, NodeMeta]:
        ordered = sorted(nodes, key=lambda n: (n.node_rank, n.node_id))
        world: Dict[int, NodeMeta] = {}
        for rank, meta in enumerate(ordered):
            meta.node_rank = rank
            world[rank] = meta
        return world
