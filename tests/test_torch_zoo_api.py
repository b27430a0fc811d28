"""The vision zoo's entry points in the port against the JAX package on
the CPU: the 43 names of `get_model` and their structural parameter
names, `get_model`'s semantics, the local model store
(`pretrained=True`), `deploy.export_serving` of a zoo model, two
`ParallelTrainer` steps of a reduced MobileNetV2, and the card as the
default device; and Inception v3's family check of
`tests/test_torch_zoo_models.py` (forward and gradients), whose helpers
and tolerances this file shares.  Tolerances: the model store and the serving artifact exact
(the same bits loaded into the same package); the port's logits from a
JAX-published file rtol and atol 1e-5 of the largest (the same weights,
the forward's sums in another order); the training steps as stated in
their test.
"""
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.gluon.model_zoo import model_store as jstore
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import deploy, gluon, models, nd, parallel
from incubator_mxnet_torch.gluon.model_zoo import model_store, vision

from test_torch_zoo_models import _pair, _weights, check_family

SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}


def test_inceptionv3_family_matches_jax():
    check_family("inceptionv3")


def test_zoo_names_match_jax():
    assert len(vision._models) == 43
    assert set(vision._models) == set(jvision._models)
    assert set(vision._models) <= set(models._MODELS)


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_zoo_model_names_match_jax(name):
    """Every zoo name builds with the JAX model's structural parameter
    names, in the same order (the keys `params_from_jax` maps)."""
    tnet = vision.get_model(name, classes=7)
    jnet = jvision.get_model(name, classes=7)
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    assert tnet._model_spec == {"name": name, "kwargs": {"classes": 7}}


def test_get_model_lower_cases_and_rejects_unknown_names():
    assert isinstance(vision.get_model("MobileNetV2_0.25"),
                      models.mobilenet.MobileNetV2)
    assert isinstance(vision.get_model("VGG11_BN")
                      .features[1], gluon.nn.BatchNorm)
    for get in (vision.get_model, jvision.get_model):
        with pytest.raises(ValueError, match="not in zoo.*alexnet"):
            get("resnet9000")
    with pytest.raises(mx.MXNetError, match="6n\\+2"):
        models.resnet.get_cifar_resnet(2, 21)
    with pytest.raises(mx.MXNetError, match="invalid resnet version"):
        models.resnet.get_resnet(3, 18)


def _publish_jax(tmp_path, name):
    """A JAX net of zoo model `name` (10 classes) with Xavier weights,
    saved and published into a store under tmp_path; returns the store,
    the input and the JAX logits."""
    mxj.random.seed(0)
    jnet = jvision.get_model(name, classes=10)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    x = np.random.RandomState(0).uniform(-1, 1, (2, 3, 32, 32)) \
        .astype(np.float32)
    jlogits = jnet(mxj.nd.array(x, ctx=mxj.cpu())).asnumpy()
    path = str(tmp_path / "w.params")
    jnet.save_parameters(path)
    root = str(tmp_path / "store")
    jstore.publish_model_file(name, path, root=root)
    return root, x, jlogits


def test_pretrained_loads_a_jax_published_file(tmp_path):
    """`get_model(..., pretrained=True, root=...)` reads the JAX store's
    manifest, checks the sha1 and gives the JAX logits; a file the port
    publishes loads in the JAX package; a tampered file fails."""
    root, x, jlogits = _publish_jax(tmp_path, "cifar_resnet20_v2")
    tnet = vision.get_model("cifar_resnet20_v2", classes=10,
                            pretrained=True, root=root, ctx=mx.cpu())
    with mx.cpu():
        out = tnet(nd.array(x)).asnumpy()
    np.testing.assert_allclose(out, jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    # the other way: the port publishes, the JAX package loads
    path = str(tmp_path / "port.params")
    tnet.save_parameters(path)
    proot = str(tmp_path / "port_store")
    stored = model_store.publish_model_file("cifar_resnet20_v2", path,
                                            root=proot)
    jnet = jvision.get_model("cifar_resnet20_v2", classes=10,
                             pretrained=True, root=proot)
    np.testing.assert_array_equal(
        jnet(mxj.nd.array(x, ctx=mxj.cpu())).asnumpy(), jlogits)
    assert model_store.get_model_file("cifar_resnet20_v2", proot) == stored
    with open(stored, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    for pkg_store in (model_store, jstore):
        with pytest.raises(Exception, match="checksum mismatch"):
            pkg_store.get_model_file("cifar_resnet20_v2", proot)
    with pytest.raises(mx.MXNetError, match="publish_model_file"):
        vision.get_model("alexnet", pretrained=True, root=proot,
                         ctx=mx.cpu())
    model_store.purge(proot)
    assert not [f for f in os.listdir(proot) if f.endswith(".params")]


def test_get_resnet_pretrained_reads_the_store(tmp_path):
    root, x, jlogits = _publish_jax(tmp_path, "resnet18_v2")
    tnet = models.resnet.resnet18_v2(classes=10, pretrained=True, root=root,
                                     ctx=mx.cpu())
    with mx.cpu():
        out = tnet(nd.array(x)).asnumpy()
    np.testing.assert_allclose(out, jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())


def test_export_serving_round_trips_a_zoo_model(tmp_path):
    net = vision.get_model("mobilenetv2_0.25", classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = np.random.RandomState(3).uniform(-1, 1, (2, 3, 32, 32)) \
        .astype(np.float32)
    with mx.cpu():
        ref = net(nd.array(x)).asnumpy()
    out = deploy.export_serving(net, [x], str(tmp_path / "art"))
    served = deploy.load_serving(out, ctx=mx.cpu())
    np.testing.assert_array_equal(served(x)[0], ref)
    assert served.meta["model"] == {"name": "mobilenetv2_0.25",
                                    "kwargs": {"classes": 10}}


def test_reduced_mobilenetv2_parallel_trainer_matches_jax():
    """Two SGD steps (momentum, wd) of MobileNetV2(0.25) on one batch of
    8 x 96² from the same weights: step 1's loss (one train-mode forward)
    to rtol 1e-5; then step 2's loss to rtol 1e-2, the whole update
    (every trained parameter's change) to a relative error of 0.6 and
    each running stat to 5e-2.  Two steps of this net are as spread as
    its train-mode gradients (the models file's docstring): the JAX
    package's own two routes, `ParallelTrainer` and the eager
    `gluon.Trainer` loop, end 1.3e-3 apart in step 2's loss and 0.28
    apart in the update; the port lies 3.8e-3 and 0.42 from the JAX
    `ParallelTrainer` (cosine 0.91), its running stats within 1e-2."""
    jnet, tnet, x = _pair("mobilenetv2", batch=8, size=96)
    w0 = _weights(jnet)
    y = np.random.RandomState(5).randint(0, 10, 8).astype(np.float32)
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jpar.ParallelTrainer(jnet, lambda o, l: jloss(o, l), "sgd", SGD,
                               mesh=jpar.default_mesh(1))
    ttr = parallel.ParallelTrainer(
        tnet, lambda o, l: tloss(o, l), "sgd", SGD,
        mesh=parallel.default_mesh(ctx=mx.cpu()))
    jd = [mxj.nd.array(a, ctx=mxj.cpu()) for a in (x, y)]
    with mx.cpu():
        td = [nd.array(a) for a in (x, y)]
    jl = [float(jtr.step(*jd).asnumpy()) for _ in range(2)]
    tl = [ttr.step(*td).asscalar() for _ in range(2)]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-2)
    got, ref = _weights(tnet), _weights(jnet)
    stats = [k for k in ref if "running" in k]
    step = [(got[k] - w0[k], ref[k] - w0[k]) for k in ref if k not in stats]
    err = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in step)
                  / sum(np.sum(b ** 2) for _, b in step))
    assert err <= 0.6, err
    for k in stats:
        assert np.linalg.norm(got[k] - ref[k]) <= \
            5e-2 * np.linalg.norm(ref[k]), k
    assert not np.allclose(got["features.1.running_mean"],
                           w0["features.1.running_mean"])


def test_zoo_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    net = vision.get_model("squeezenet1.1")
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        net.initialize()
    root, _, _ = _publish_jax(tmp_path, "cifar_resnet20_v1")
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        vision.get_model("cifar_resnet20_v1", classes=10, pretrained=True,
                         root=root)
