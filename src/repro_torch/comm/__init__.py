from .base import DenseReducer, WorkerGroup, destroy_groups, make_reducer, pmax, psum
from .int8 import Int8Reducer, verify_quantize_kernels
from .topk import TopKReducer
from .topology import (CONSENSUS_TARGET, FlatTopology, GossipTopology, HierTopology, Topology,
                       default_gossip_rounds, gossip_lambda2, make_topology)

__all__ = ["CONSENSUS_TARGET", "DenseReducer", "FlatTopology", "GossipTopology", "HierTopology",
           "Int8Reducer", "TopKReducer", "Topology", "WorkerGroup",
           "default_gossip_rounds", "destroy_groups", "gossip_lambda2", "make_reducer",
           "make_topology", "pmax", "psum", "verify_quantize_kernels"]
