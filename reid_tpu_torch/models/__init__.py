"""Models of the port (SERes18-IBN in this slice)."""

from .factory import build_model
from .seres18 import SEBasicBlock, SERes18IBN

__all__ = ["build_model", "SEBasicBlock", "SERes18IBN"]
