from .alexnet import ALEXNET_DAU_VARIANTS, AlexNetDAU
from .cifar import ConvCifarNet, DAUCifarNet
from .resnet import RESNET_DAU_DEPTHS, DAUBasicBlock, DAUResNet

__all__ = ["AlexNetDAU", "ALEXNET_DAU_VARIANTS", "ConvCifarNet", "DAUCifarNet",
           "DAUBasicBlock", "DAUResNet", "RESNET_DAU_DEPTHS"]
