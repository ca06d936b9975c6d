from .conv import FullGraph, GATConv, GCNConv, SAGEConv
from .convert import params_from_jax
from .gnn import HomoGNN, accuracy, cross_entropy_loss, make_conv

__all__ = ["FullGraph", "GATConv", "GCNConv", "SAGEConv", "HomoGNN", "accuracy",
           "cross_entropy_loss", "make_conv", "params_from_jax"]
