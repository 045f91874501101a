"""The model families (ResNet, VGG, DenseNet, ViT, Swin, EfficientNet,
MobileNetV2, ConvNeXt, WideResNet, PreActResNet, the tiny CNN, the IBP nets), the
model registry and the weight bridge."""

from .convert import from_jax_variables, load_torch_checkpoint
from .resnet import ResNet, resnet50, resnet_tiny
from .zoo import ModelBundle, list_models, load_model, model_meta

__all__ = ["ModelBundle", "ResNet", "from_jax_variables", "list_models",
           "load_model", "load_torch_checkpoint", "model_meta", "resnet50",
           "resnet_tiny"]
