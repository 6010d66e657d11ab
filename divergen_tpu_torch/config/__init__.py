from .config import ConfigNode
from .defaults import get_cfg

__all__ = ["ConfigNode", "get_cfg"]
