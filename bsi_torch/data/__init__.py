from .base import ArrayDataModule, SyntheticDataModule
from .cifar10 import CIFAR10DataModule
from .imagenet import ImageNetDataModule
from .npysource import NpyRowSource
from .sampler import InfiniteIndexStream, eval_shard, padded_batches

__all__ = [
    "ArrayDataModule",
    "SyntheticDataModule",
    "CIFAR10DataModule",
    "ImageNetDataModule",
    "NpyRowSource",
    "InfiniteIndexStream",
    "eval_shard",
    "padded_batches",
]
