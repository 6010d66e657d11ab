from . import boxes
from .image_list import ImageList
from .instances import Instances, empty_instances
from .masks import crop_and_resize, mask_areas, masks_to_boxes

__all__ = [
    "boxes",
    "ImageList",
    "Instances",
    "empty_instances",
    "crop_and_resize",
    "mask_areas",
    "masks_to_boxes",
]
