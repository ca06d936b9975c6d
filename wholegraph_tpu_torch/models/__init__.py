from .conv import SAGEConv
from .convert import params_from_jax
from .gnn import HomoGNN, accuracy, cross_entropy_loss

__all__ = ["SAGEConv", "HomoGNN", "accuracy", "cross_entropy_loss", "params_from_jax"]
