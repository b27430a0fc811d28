"""Model implementations and the registry of model constructors.

A block built through `get_model(name, **kwargs)` remembers how it was
built, so `deploy.export_serving` can record the constructor in the
artifact and `deploy.load_serving` can rebuild the same block on the
card.  The registry holds the vision zoo's 43 names
(`gluon.model_zoo.vision._models`) beside BERT, LeNet, the LSTM LM and
the MLP."""
from . import (bert, lenet, lstm_lm, mlp, resnet, vgg, mobilenet, alexnet,
               densenet, squeezenet, inception)
from .lenet import LeNet
from .mlp import MLP
from .lstm_lm import LSTMLanguageModel
from .bert import (BERTModel, BERTEncoder, BERTClassifier, get_bert_model,
                   bert_12_768_12, bert_mini)
from .resnet import (ResNetV1, BasicBlockV1, BottleneckV1, get_resnet,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet50_v1b, resnet101_v1b, resnet152_v1b)
from ..base import MXNetError
from ..gluon.model_zoo.vision import _models as _zoo

_MODELS = {
    "bert_classifier": bert.bert_classifier,
    "lenet": LeNet,
    "lstm_lm": LSTMLanguageModel,
    "mlp": MLP,
    **_zoo,
}


def get_model(name, **kwargs):
    """Build registered model `name` with JSON-serializable `kwargs`."""
    try:
        ctor = _MODELS[name]
    except KeyError:
        raise MXNetError(f"unknown model {name!r}; have "
                         f"{sorted(_MODELS)}") from None
    block = ctor(**kwargs)
    block._model_spec = {"name": name, "kwargs": dict(kwargs)}
    return block
