from .embedding import Embedding
from .optimizers import AdaGrad, LazyAdam, RMSProp, SGD, SparseOptimizer, create_optimizer

__all__ = ["Embedding", "AdaGrad", "LazyAdam", "RMSProp", "SGD", "SparseOptimizer",
           "create_optimizer"]
