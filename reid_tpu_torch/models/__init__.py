"""Models of the port: the SERes18-IBN family (SE, triplet and EMA block
attention), the torchvision-style ResNets, OSNet and PLR-OSNet, ViT-t
with SIE, Swin-T v1 / v2 and the 3-D video ResNets."""

from .attention_modules import AttentionModule, MCALayer, PAMModule, SEModule
from .baseline import BasicBlock, Bottleneck, NonLocalBlock, ResNetReID
from .ema_attention import EMAttention
from .factory import build_model
from .osnet import OSBlock, OSNet, PLROSNet
from .seres18 import SEBasicBlock, SERes18IBN
from .swin import SwinBlock, SwinTransformer, WindowAttention
from .triplet_attention import TripletAttention
from .video3d import Bottleneck3D, MixedNorm3D, VideoResNet
from .vit import TransformerBlock, ViT

__all__ = ["build_model", "AttentionModule", "BasicBlock", "Bottleneck",
           "Bottleneck3D", "EMAttention", "MCALayer", "MixedNorm3D",
           "NonLocalBlock", "OSBlock", "OSNet", "PAMModule", "PLROSNet",
           "ResNetReID", "SEBasicBlock", "SEModule", "SERes18IBN",
           "SwinBlock", "SwinTransformer", "TransformerBlock",
           "TripletAttention", "VideoResNet", "ViT", "WindowAttention"]
