"""The name `mxnet` for the port (`incubator_mxnet_torch.mxnet_alias`,
`python -m incubator_mxnet_torch.run`), in subprocesses: this test
process already imports the JAX package's `mxnet/` shim.

The stock examples run unchanged on the CPU through the port and
through the JAX shim, at once in two processes; their results are held
within these margins, since the two packages' weight initializations
and shuffles draw from different random streams:
- `train_mnist.py --synthetic` (n = 4096, one epoch), MLP and LeNet:
  final validation accuracy within 0.02 of the JAX package's, and at
  least 0.9;
- `lstm_bucketing.py --num-epochs 1 --num-sentences 200`: the epoch's
  training perplexity within 2% of the JAX package's (both near the
  64-word uniform, 64, after this short epoch);
- `quantization/quantize_model.py` (both `quantize_net` with entropy
  calibration and `quantize_model`): each of its three accuracies
  within 0.02 of the JAX package's and at least 0.9.  The example
  writes its graph under one fixed path in /tmp, so each run takes a
  copy of it that writes into a directory of its own.
The port runs with `--seed 0`, which fixes its weights and its
shuffle (the port's generators and `NDArrayIter`'s order draw fresh
entropy unless seeded; the JAX package's weights start from a fixed key,
its shuffle from fresh entropy).  Each
subprocess has a time limit of its own (`timeout=`) and two CPU threads
(`OMP_NUM_THREADS=2`), so runs beside other test workers stay quick.
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(ROOT, "example", "image-classification",
                     "train_mnist.py")
QUANT = os.path.join(ROOT, "example", "quantization", "quantize_model.py")
LSTM = os.path.join(ROOT, "example", "rnn", "bucketing",
                    "lstm_bucketing.py")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "2"
    return env


def _start(argv):
    return subprocess.Popen([sys.executable] + argv, cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _both(script, args, timeout):
    """(port output, JAX output) of `script args`, run together."""
    port = _start(["-m", "incubator_mxnet_torch.run", "--ctx", "cpu",
                   "--seed", "0", script] + args)
    jax = _start([script] + args)
    outs = []
    for p in (port, jax):
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, out + err
        outs.append(out + err)
    return outs


def test_alias_is_the_port():
    """`import mxnet` after `install()` is the port: every submodule is
    the port's module object; `tpu`/`num_tpus` exist on the alias only.
    The runner passes ARGS as the script's argv, runs it as `__main__`
    under `--ctx cpu`, and prints its usage for a bad call."""
    code = (
        "import sys\n"
        "from incubator_mxnet_torch.mxnet_alias import install\n"
        "mx = install()\n"
        "import mxnet, incubator_mxnet_torch as impl\n"
        "assert mxnet is mx and install() is mx\n"
        "bad = [n for n, m in sys.modules.items()\n"
        "       if n.startswith('incubator_mxnet_torch.')\n"
        "       and sys.modules.get('mxnet' + n[len('incubator_mxnet_torch'):])\n"
        "       is not m]\n"
        "assert not bad, bad\n"
        "from mxnet.gluon.data.vision import MNIST\n"
        "import mxnet.symbol as s\n"
        "assert s is impl.symbol and mx.sym is impl.sym and mx.mod is impl.mod\n"
        "assert MNIST is impl.gluon.data.vision.MNIST\n"
        "assert mx.tpu is impl.gpu and mx.num_tpus is impl.num_gpus\n"
        "assert not hasattr(impl, 'tpu') and not hasattr(impl, 'num_tpus')\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'incubator_mxnet_tpu' not in sys.modules\n"
        "from incubator_mxnet_torch import run\n"
        "try:\n"
        "    run.main([])\n"
        "except SystemExit as e:\n"
        "    assert 'usage' in str(e)\n"
        "else:\n"
        "    raise AssertionError('no usage')\n"
        "import contextlib, io, os, tempfile\n"
        "probe = os.path.join(tempfile.mkdtemp(), 'probe.py')\n"
        "open(probe, 'w').write('import sys, mxnet as mx\\n'\n"
        "    'print(sys.argv[1:], mx.current_context(), __name__)\\n')\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    run.main(['--ctx', 'cpu', '--seed', '3', probe, 'a', '--b'])\n"
        "assert buf.getvalue().strip() == \"['a', '--b'] cpu(0) __main__\", buf.getvalue()\n"
        "print('OK', len([n for n in sys.modules if n.startswith('mxnet.')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")
    assert int(r.stdout.split()[1]) > 50


def _accuracy(out):
    return float(re.search(r"final validation accuracy: ([0-9.]+)",
                           out).group(1))


@pytest.mark.parametrize("network", ["mlp", "lenet"])
def test_train_mnist_matches_jax(network):
    args = ["--synthetic", "--network", network, "--num-epochs", "1"]
    port, jax = _both(MNIST, args, timeout=120)
    acc = [_accuracy(port), _accuracy(jax)]
    # the example's recipe (lr 0.1, momentum 0.9) sends LeNet to chance
    # in about 1 of 16 shuffles in either package (measured on the CPU:
    # 1 of 16 seeds each); the JAX run's shuffle draws fresh entropy, so
    # a JAX run at chance is run again, at most twice
    for _ in range(2):
        if acc[1] > 0.2:
            break
        p = _start([MNIST] + args)
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
        acc[1] = _accuracy(out + err)
    assert acc[0] >= 0.9, port
    assert abs(acc[0] - acc[1]) <= 0.02, (acc, port)


def test_lstm_bucketing_matches_jax():
    port, jax = _both(LSTM, ["--num-epochs", "1", "--num-sentences", "200"],
                      timeout=120)
    ppl = [float(re.search(r"Train-perplexity=([0-9.]+)", o).group(1))
           for o in (port, jax)]
    assert abs(ppl[0] - ppl[1]) <= 0.02 * ppl[1], (ppl, port)
    assert "buckets compiled: [16, 24, 32]" in port


def _quant_accuracies(out):
    return [float(a) for a in re.findall(r"acc=([0-9.]+)", out)]


QUANT_PREFIX = '"/tmp/quantize_example"'


def _private_quant(dir_):
    """A copy of the quantization example in `dir_` that writes its
    graph there instead of at its fixed path in /tmp."""
    with open(QUANT) as f:
        text = f.read()
    assert text.count(QUANT_PREFIX) == 1
    dir_.mkdir()
    script = dir_ / "quantize_model.py"
    script.write_text(text.replace(
        QUANT_PREFIX, repr(str(dir_ / "quantize_example"))))
    return str(script)


def test_quantization_example_matches_jax(tmp_path):
    procs = [_start(["-m", "incubator_mxnet_torch.run", "--ctx", "cpu",
                     "--seed", "0", _private_quant(tmp_path / "port")]),
             _start([_private_quant(tmp_path / "jax")])]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, out + err
        outs.append(out + err)
    port, jax = (_quant_accuracies(o) for o in outs)
    assert len(port) == len(jax) == 3, outs
    assert min(port) >= 0.9, outs[0]
    assert all(abs(a - b) <= 0.02 for a, b in zip(port, jax)), (port, jax)
    assert "3 layers quantized" in outs[0]
