"""Models of the port: SERes18-IBN and the torchvision-style ResNets."""

from .baseline import BasicBlock, Bottleneck, NonLocalBlock, ResNetReID
from .factory import build_model
from .seres18 import SEBasicBlock, SERes18IBN

__all__ = ["build_model", "BasicBlock", "Bottleneck",
           "NonLocalBlock", "ResNetReID", "SEBasicBlock", "SERes18IBN"]
