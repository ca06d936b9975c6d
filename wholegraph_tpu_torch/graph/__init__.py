from .structure import GraphStructure, HopSubgraph, MultilayerSample

__all__ = ["GraphStructure", "HopSubgraph", "MultilayerSample"]
