from .cache import (TouchCounter, decay, hot_ids_by_count, hot_ids_by_degree,
                    make_touch_counter, touch)
from .embedding import Embedding
from .host_embedding import HostEmbedding
from .optimizers import AdaGrad, LazyAdam, RMSProp, SGD, SparseOptimizer, create_optimizer

__all__ = ["Embedding", "HostEmbedding", "AdaGrad", "LazyAdam", "RMSProp", "SGD",
           "SparseOptimizer", "create_optimizer", "TouchCounter", "decay",
           "hot_ids_by_count", "hot_ids_by_degree", "make_touch_counter", "touch"]
