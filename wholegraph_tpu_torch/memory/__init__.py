from .partition import PartitionPlan
from .sharded_table import ShardedTable

__all__ = ["PartitionPlan", "ShardedTable"]
