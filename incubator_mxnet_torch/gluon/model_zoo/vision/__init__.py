"""Vision model zoo (counterpart of
`incubator_mxnet_tpu/gluon/model_zoo/vision/__init__.py`): the model
classes and constructors under the JAX package's names, the `_models`
table of the 43 zoo names, and `get_model`.  The table is also part of
`models.get_model`'s registry, so a zoo model exported with
`deploy.export_serving` is rebuilt by name."""
from ....models.resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2,
                               BottleneckV1, BottleneckV2,
                               resnet18_v1, resnet34_v1, resnet50_v1,
                               resnet101_v1, resnet152_v1,
                               resnet18_v2, resnet34_v2, resnet50_v2,
                               resnet101_v2, resnet152_v2,
                               resnet50_v1b, resnet101_v1b, resnet152_v1b,
                               get_resnet, get_cifar_resnet,
                               cifar_resnet20_v1, cifar_resnet56_v1,
                               cifar_resnet110_v1, cifar_resnet20_v2,
                               cifar_resnet56_v2, cifar_resnet110_v2)
from ....models.lenet import LeNet  # noqa: F401
from ....models.mlp import MLP  # noqa: F401
from ....models.vgg import VGG, vgg11, vgg13, vgg16, vgg19
from ....models.mobilenet import (MobileNet, MobileNetV2, mobilenet1_0,
                                  mobilenet_v2_1_0)
from ....models.alexnet import AlexNet, alexnet  # noqa: F401
from ....models.densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                                 densenet169, densenet201)
from ....models.squeezenet import (SqueezeNet, squeezenet1_0,  # noqa: F401
                                   squeezenet1_1)
from ....models.inception import Inception3, inception_v3  # noqa: F401

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "resnet50_v1b": resnet50_v1b, "resnet101_v1b": resnet101_v1b,
    "resnet152_v1b": resnet152_v1b,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "mobilenet1.0": mobilenet1_0, "mobilenetv2_1.0": mobilenet_v2_1_0,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "cifar_resnet20_v1": cifar_resnet20_v1,
    "cifar_resnet56_v1": cifar_resnet56_v1,
    "cifar_resnet110_v1": cifar_resnet110_v1,
    "cifar_resnet20_v2": cifar_resnet20_v2,
    "cifar_resnet56_v2": cifar_resnet56_v2,
    "cifar_resnet110_v2": cifar_resnet110_v2,
}


def _vgg_bn(n):
    def ctor(**kwargs):
        return _models[f"vgg{n}"](batch_norm=True, **kwargs)
    return ctor


def _width(cls, multiplier):
    def ctor(**kwargs):
        return cls(multiplier, **kwargs)
    return ctor


for _n in (11, 13, 16, 19):
    _models[f"vgg{_n}_bn"] = _vgg_bn(_n)
for _mult, _tag in ((0.25, "0.25"), (0.5, "0.5"), (0.75, "0.75")):
    _models[f"mobilenet{_tag}"] = _width(MobileNet, _mult)
    _models[f"mobilenetv2_{_tag}"] = _width(MobileNetV2, _mult)


def get_model(name, **kwargs):
    """Build zoo model `name` (case-insensitive); an unknown name raises
    ValueError.  With `pretrained=True` the weights come from the local
    model store (`root`, default `$MXNET_HOME/models`), sha1-checked,
    onto `ctx` (the card by default); nothing is downloaded."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"model {name!r} not in zoo; available: {sorted(_models)}")
    pretrained = kwargs.pop("pretrained", False)
    root = kwargs.pop("root", None)
    ctx = kwargs.pop("ctx", None) if pretrained else None
    from ....models import get_model as build
    net = build(name, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, name, root=root, ctx=ctx)
    return net
