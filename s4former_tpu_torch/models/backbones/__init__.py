"""Backbones; importing registers them."""
from s4former_tpu_torch.models.backbones.vit import VisionTransformer  # noqa: F401
from s4former_tpu_torch.models.backbones.mit import MixVisionTransformer  # noqa: F401
from s4former_tpu_torch.models.backbones.resnet import (  # noqa: F401
    ResNet, ResNetV1c, ResNetV1d)
from s4former_tpu_torch.models.backbones.cnn_zoo import (  # noqa: F401
    BiSeNetV1, BiSeNetV2, CGNet, ERFNet, FastSCNN, ICNet, ResNeSt, ResNeXt,
    STDCContextPathNet, STDCNet)
from s4former_tpu_torch.models.backbones.mobilenet import MobileNetV3  # noqa: F401
from s4former_tpu_torch.models.backbones.hrnet import HRNet  # noqa: F401
from s4former_tpu_torch.models.backbones.swin import SwinTransformer  # noqa: F401
