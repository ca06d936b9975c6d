from .conv import FullGraph, GATConv, GCNConv, RGCNConv, SAGEConv
from .convert import params_from_jax
from .gnn import (HeteroGNN, HomoGNN, TypedProjection, accuracy, cross_entropy_loss, make_conv,
                  resolve_framework)

__all__ = ["FullGraph", "GATConv", "GCNConv", "RGCNConv", "SAGEConv", "HeteroGNN", "HomoGNN",
           "TypedProjection", "accuracy", "cross_entropy_loss", "make_conv", "params_from_jax",
           "resolve_framework"]
