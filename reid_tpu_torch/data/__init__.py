"""Data layer of the port for evaluation: dataset parsers, the image store,
the prefetch loader and the inference transform."""

from .dataset import ReIDDataset, synthetic_dataset
from .datasets import (BaseImageDataset, DukeMTMC, Market1501, VeRi776,
                       build_dataset)

__all__ = ["ReIDDataset", "synthetic_dataset", "BaseImageDataset",
           "DukeMTMC", "Market1501", "VeRi776", "build_dataset"]
