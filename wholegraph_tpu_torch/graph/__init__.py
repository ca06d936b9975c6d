from .dataset import (NodeClassificationDataset, NodeClassificationSplit, batch_iterator,
                      synthetic_dataset)
from .hetero import (HeteroFeatureStore, NodeTypeSpace, build_hetero_graph,
                     synthetic_hetero_dataset)
from .structure import GraphStructure, HopSubgraph, MultilayerSample

__all__ = ["GraphStructure", "HeteroFeatureStore", "HopSubgraph", "MultilayerSample",
           "NodeClassificationDataset", "NodeClassificationSplit", "NodeTypeSpace",
           "batch_iterator", "build_hetero_graph", "synthetic_dataset",
           "synthetic_hetero_dataset"]
