from .catalog import DatasetCatalog, MetadataCatalog
from .inst_pool import InstPool
from .samplers import (
    InferenceSampler,
    MultiDatasetSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
    repeat_factors_from_category_frequency,
    repeat_factors_from_tag_frequency,
)

__all__ = [
    "DatasetCatalog",
    "MetadataCatalog",
    "InstPool",
    "InferenceSampler",
    "MultiDatasetSampler",
    "RepeatFactorTrainingSampler",
    "TrainingSampler",
    "repeat_factors_from_category_frequency",
    "repeat_factors_from_tag_frequency",
]
