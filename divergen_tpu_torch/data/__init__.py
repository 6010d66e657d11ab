from .catalog import DatasetCatalog, MetadataCatalog

__all__ = ["DatasetCatalog", "MetadataCatalog"]
