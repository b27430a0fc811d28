"""The port stands alone: it imports neither JAX nor the JAX package nor
PIL or OpenCV, and its entry points never carry on quietly on the
CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import deploy, nd
from incubator_mxnet_torch.models import get_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "incubator_mxnet_torch")
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu", "mxnet", "PIL", "cv2")


def test_import_pulls_in_no_jax():
    # a subprocess: this test process already imported the JAX package
    # (tests/conftest.py seeds it for every test)
    code = ("import sys, incubator_mxnet_torch, "
            "incubator_mxnet_torch.deploy, incubator_mxnet_torch.serving, "
            "incubator_mxnet_torch.convert, incubator_mxnet_torch._kernels, "
            "incubator_mxnet_torch.autograd, incubator_mxnet_torch.optimizer, "
            "incubator_mxnet_torch.parallel, "
            "incubator_mxnet_torch.gluon.trainer, "
            "incubator_mxnet_torch.gluon.loss, "
            "incubator_mxnet_torch.gluon.model_zoo.vision, "
            "incubator_mxnet_torch.tools.bottleneck_bwd, "
            "incubator_mxnet_torch.io, incubator_mxnet_torch.recordio, "
            "incubator_mxnet_torch.gluon.data.vision, "
            "incubator_mxnet_torch.gluon.contrib.estimator, "
            "incubator_mxnet_torch.image, incubator_mxnet_torch._native, "
            "incubator_mxnet_torch.io.native_image, "
            "incubator_mxnet_torch.tools.im2rec, "
            "incubator_mxnet_torch.tools.io_bench, "
            "incubator_mxnet_torch.telemetry, incubator_mxnet_torch.tracing, "
            "incubator_mxnet_torch.introspect, incubator_mxnet_torch.router, "
            "incubator_mxnet_torch.tools.serve_chaos, "
            "incubator_mxnet_torch.tools.fleet_chaos\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print('BAD', bad)\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for f in sorted(os.listdir(os.path.join(ROOT, "experiments"))):
        if f.endswith(".py"):
            yield os.path.join(ROOT, "experiments", f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


@pytest.mark.parametrize("entry", ["initialize", "array", "zeros",
                                   "load_serving", "default_mesh",
                                   "ParallelTrainer", "Updater.set_states",
                                   "DataLoader", "DevicePrefetcher"])
def test_entry_point_without_ctx_raises_without_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        if entry == "default_mesh":
            mx.parallel.default_mesh()
        elif entry == "ParallelTrainer":
            net = get_model("bert_classifier", model_name="bert_tiny",
                            vocab_size=10, max_length=8)
            net.initialize(ctx=mx.cpu())
            mx.parallel.ParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam")
        elif entry == "Updater.set_states":
            up = mx.optimizer.get_updater(mx.optimizer.create("sgd",
                                                              momentum=0.9))
            with mx.cpu():
                up(0, nd.zeros((2,)), nd.zeros((2,)))
            mx.optimizer.get_updater(mx.optimizer.create("sgd")).set_states(
                up.get_states())
        elif entry == "initialize":
            net = get_model("bert_classifier", model_name="bert_tiny",
                            vocab_size=10, max_length=8)
            net.initialize()
        elif entry == "array":
            nd.array([1.0, 2.0])
        elif entry == "DataLoader":
            iter(mx.gluon.data.DataLoader(
                mx.gluon.data.ArrayDataset([1.0, 2.0]), 2))
        elif entry == "DevicePrefetcher":
            mx.io.DevicePrefetcher([(1.0, 2.0)])
        elif entry == "zeros":
            nd.zeros((2, 2))
        else:
            net = get_model("bert_classifier", model_name="bert_tiny",
                            vocab_size=10, max_length=8)
            net.initialize(ctx=mx.cpu())
            x = torch.zeros(2, 8, dtype=torch.int32)
            out = deploy.export_serving(net, [x, x, torch.zeros(2)],
                                        str(tmp_path / "a"))
            deploy.load_serving(out)


def test_default_context_is_the_card_and_cpu_is_explicit():
    assert mx.current_context() == mx.gpu(0)
    with mx.cpu():
        assert nd.zeros((2,)).context == mx.cpu()
        net = get_model("bert_classifier", model_name="bert_tiny",
                        vocab_size=10, max_length=8)
        net.initialize()
        assert all(p.device.type == "cpu" for p in net.parameters())


def test_trainers_on_cpu_keep_everything_on_cpu():
    """Asked for cpu(), both trainers keep weights, gradients and
    optimizer states there."""
    net = get_model("bert_classifier", model_name="bert_tiny",
                    vocab_size=10, max_length=8, dropout=0.0)
    net.initialize(ctx=mx.cpu())
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.cpu():
        x, y = nd.zeros((2, 8)), nd.array([0.0, 1.0])
    tr = mx.parallel.ParallelTrainer(
        net, loss, "adam", mesh=mx.parallel.default_mesh(ctx=mx.cpu()))
    tr.step(x, x, y)
    assert {s.device.type for st in tr._states for s in st} == {"cpu"}
    gtr = mx.gluon.Trainer(net.collect_params(), "sgd",
                           {"momentum": 0.9})
    with mx.autograd.record():
        l = loss(net(x, x), y)
    l.backward()
    gtr.step(2)
    assert {s.context for s in gtr._states} == {mx.cpu()}
    assert all(p.device.type == "cpu" for p in net.parameters())


def test_hybridize_is_accepted_and_changes_nothing():
    net = get_model("bert_classifier", model_name="bert_tiny",
                    vocab_size=10, max_length=8, dropout=0.0)
    net.initialize(ctx=mx.cpu())
    x = torch.ones(2, 8, dtype=torch.int32)
    with torch.no_grad():
        a = net(x, x, torch.tensor([8, 3]))
        net.hybridize()
        b = net(x, x, torch.tensor([8, 3]))
    assert torch.equal(a, b)


def test_parameters_are_nn_parameters_and_cast_follows():
    net = get_model("bert_classifier", model_name="bert_tiny",
                    vocab_size=10, max_length=8, dropout=0.0)
    net.initialize(ctx=mx.cpu())
    x = torch.ones(2, 8, dtype=torch.int32)
    with torch.no_grad():
        net(x, x, None)                  # finishes the deferred Dense
    named = dict(net.named_parameters())
    assert len(named) == len(net._collect_params_with_prefix())
    assert all(isinstance(p, torch.nn.Parameter) for p in named.values())
    net.cast("bfloat16")
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    assert dict(net.named_parameters())["bert.word_embed.weight"] is \
        net.bert.word_embed.weight._data


def test_save_load_parameters_round_trip(tmp_path):
    mx.seed(3)
    net = get_model("bert_classifier", model_name="bert_tiny",
                    vocab_size=10, max_length=8, dropout=0.0)
    net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    x = torch.ones(2, 8, dtype=torch.int32)
    net.cast("bfloat16")
    with torch.no_grad():
        ref = net(x, x, torch.tensor([8, 0]))
    path = str(tmp_path / "w.npz")
    net.save_parameters(path)
    net2 = get_model("bert_classifier", model_name="bert_tiny",
                     vocab_size=10, max_length=8, dropout=0.0)
    net2.cast("bfloat16")
    net2.load_parameters(path, ctx=mx.cpu())
    with torch.no_grad():
        assert torch.equal(net2(x, x, torch.tensor([8, 0])), ref)
