from .dataset import (NodeClassificationDataset, NodeClassificationSplit, batch_iterator,
                      synthetic_dataset)
from .structure import GraphStructure, HopSubgraph, MultilayerSample

__all__ = ["GraphStructure", "HopSubgraph", "MultilayerSample", "NodeClassificationDataset",
           "NodeClassificationSplit", "batch_iterator", "synthetic_dataset"]
