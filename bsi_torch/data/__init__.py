from .base import ArrayDataModule, SyntheticDataModule
from .cifar10 import CIFAR10DataModule
from .sampler import InfiniteIndexStream, eval_shard, padded_batches

__all__ = [
    "ArrayDataModule",
    "SyntheticDataModule",
    "CIFAR10DataModule",
    "InfiniteIndexStream",
    "eval_shard",
    "padded_batches",
]
