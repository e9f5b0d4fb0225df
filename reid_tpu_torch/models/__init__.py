"""Models of the port: the SERes18-IBN family (SE, triplet and EMA block
attention) and the torchvision-style ResNets."""

from .baseline import BasicBlock, Bottleneck, NonLocalBlock, ResNetReID
from .ema_attention import EMAttention
from .factory import build_model
from .seres18 import SEBasicBlock, SERes18IBN
from .triplet_attention import TripletAttention

__all__ = ["build_model", "BasicBlock", "Bottleneck", "EMAttention",
           "NonLocalBlock", "ResNetReID", "SEBasicBlock", "SERes18IBN",
           "TripletAttention"]
