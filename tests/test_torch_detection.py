"""The detection ops and the SSD example's loop, port against the JAX
package on the CPU, from the same numpy inputs: MultiBoxTarget (padded
label rows, two labels claiming one anchor), MultiBoxDetection
(force_suppress, score ties, clip, and 1,024 anchors so the blocked
sweep crosses several blocks), box_nms (topk, id_index, valid_thresh,
the formats), bipartite_matching (is_ascend, topk, ties), ROIAlign and
ROIPooling with RoIs partly outside the image (and their gradients),
and `example/ssd/train_ssd.py`'s TinySSD for five Adam steps from one
set of weights carried by `convert.params_from_jax`.

Tolerances, with their reasons:

- kept and matched sets, targets' masks and class targets, the rows
  that NMS marks: exact (the same comparisons of the same float32
  IoUs and scores);
- continuous outputs (box targets, decoded boxes, pooled values):
  rtol 1e-6 with atol 1e-6 of the largest value (the same float32
  arithmetic, reordered sums);
- pooled gradients: rtol 1e-5, atol 1e-6 of the largest value (the
  scatter of the gathers' gradients adds in another order);
- TinySSD losses and decoded detections after five steps: 1e-5
  (float32 convolutions summed in another order, carried through
  Adam); the kept detections' classes exact.
"""
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import gluon, nd
from incubator_mxnet_torch.convert import params_from_jax

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "example", "ssd",
                       "train_ssd.py")


def _np(a):
    return np.asarray(a.asnumpy()).astype(np.float64)


def _close(got, ref, what, rtol=1e-6, atol_of_max=1e-6):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=rtol,
        atol=atol_of_max * max(np.abs(ref).max(initial=0), 1e-30),
        err_msg=what)


def _both(name, arrays, **kw):
    """(port outputs, JAX outputs) of op `name` as lists."""
    with mx.cpu():
        got = getattr(nd, name)(*[nd.array(a, dtype=a.dtype)
                                  for a in arrays], **kw)
    ref = getattr(mxj.nd, name)(*[mxj.nd.array(a, dtype=a.dtype)
                                  for a in arrays], **kw)
    as_list = (lambda o: list(o) if isinstance(o, (tuple, list)) else [o])
    return as_list(got), as_list(ref)


def _boxes(rng, shape, lo=0.0, hi=1.0, min_wh=0.05, max_wh=0.4):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------- MultiBoxTarget
def test_multibox_target_padded_labels_and_shared_anchor():
    rng = np.random.RandomState(0)
    anchors = _boxes(rng, (1, 60))
    label = np.full((3, 5, 5), -1.0, np.float32)
    for i, n in enumerate((5, 2, 0)):                 # rows past n pad
        label[i, :n, 0] = rng.randint(0, 3, n)
        label[i, :n, 1:] = _boxes(rng, (n,))
    # image 1: its two labels are the same box, so both claim one anchor
    label[1, 1, 1:] = label[1, 0, 1:]
    cls_pred = rng.randn(3, 4, 60).astype(np.float32)
    got, ref = _both("MultiBoxTarget", [anchors, label, cls_pred],
                     overlap_threshold=0.3)
    np.testing.assert_array_equal(_np(got[1]), _np(ref[1]))   # masks
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))   # classes
    _close(got[0], ref[0], "box targets")
    assert _np(ref[2])[1].max() == 1 + label[1, 1, 0]         # later wins
    assert not _np(ref[1])[2].any()                           # all padding


# ------------------------------------------------------ MultiBoxDetection
def _detection_inputs(seed, n=2, classes=4, size=16, ties=False):
    rng = np.random.RandomState(seed)
    with mx.cpu():
        anchors = nd.contrib.MultiBoxPrior(
            nd.zeros((1, 3, size, size)), sizes=(0.2, 0.35),
            ratios=(1.0, 2.0, 0.5)).asnumpy()
    A = anchors.shape[1]
    logits = rng.randn(n, classes, A).astype(np.float32) * 2
    if ties:                       # every fourth anchor repeats its left one
        logits[:, :, 4::4] = logits[:, :, 3:-1:4][:, :, :logits[:, :, 4::4]
                                                  .shape[2]]
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = rng.randn(n, A * 4).astype(np.float32) * 0.5
    return [prob.astype(np.float32), loc, anchors]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(force_suppress=True, nms_threshold=0.3),
    dict(clip=False, threshold=0.2, background_id=2),
    dict(nms_threshold=0.6, variances=(0.2, 0.2, 0.1, 0.1)),
], ids=["default", "force_suppress", "no_clip", "variances"])
@pytest.mark.parametrize("ties", [False, True], ids=["", "ties"])
def test_multibox_detection_matches_jax(kw, ties):
    arrays = _detection_inputs(1, ties=ties)
    assert arrays[2].shape[1] == 1024          # eight blocks of the sweep
    (got,), (ref,) = _both("MultiBoxDetection", arrays, **kw)
    g, r = _np(got), _np(ref)
    np.testing.assert_array_equal(g[..., 0] >= 0, r[..., 0] >= 0)
    np.testing.assert_array_equal(g[..., 0], r[..., 0])
    _close(got, ref, f"detections {kw}")
    kept = (r[..., 0] >= 0).sum()
    assert 0 < kept < r.shape[0] * r.shape[1]


def test_multibox_detection_nms_is_the_sequential_sweep():
    """The blocked sweep against a plain one-box-per-step loop in numpy
    over the JAX op's sorted boxes."""
    from incubator_mxnet_torch.ops.extended import box_iou_corner, greedy_nms
    import torch
    rng = np.random.RandomState(4)
    boxes = torch.from_numpy(_boxes(rng, (3, 700), max_wh=0.3))
    ids = torch.from_numpy(rng.randint(0, 2, (3, 700)).astype(np.float32))
    sup_ok = torch.from_numpy(rng.rand(3, 700) < 0.8)
    got = greedy_nms(boxes, 0.4, box_iou_corner, ids=ids,
                     suppressor=sup_ok).numpy()          # six blocks
    iou = box_iou_corner(boxes, boxes).numpy()
    for b in range(3):
        alive = np.ones(700, bool)
        for i in range(700):
            if alive[i] and sup_ok[b, i]:
                row = (iou[b, i] > 0.4) & (ids[b].numpy() == ids[b, i].item())
                row[:i + 1] = False
                alive &= ~row
        np.testing.assert_array_equal(got[b], alive)


# ----------------------------------------------------------------- box_nms
def _nms_rows(seed, fmt="corner"):
    rng = np.random.RandomState(seed)
    b = _boxes(rng, (2, 3, 40), max_wh=0.5)
    if fmt == "center":
        b = np.concatenate([(b[..., :2] + b[..., 2:]) / 2,
                            b[..., 2:] - b[..., :2]], -1)
    ids = rng.randint(0, 3, (2, 3, 40, 1)).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 3, 40, 1)).astype(np.float32)
    scores[..., ::7, :] = scores[..., 1::7, :][..., :scores[..., ::7, :]
                                               .shape[-2], :]   # ties
    return np.concatenate([ids, scores, b], -1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(overlap_thresh=0.3, valid_thresh=0.4),
    dict(topk=12),
    dict(id_index=0, overlap_thresh=0.2),
    dict(id_index=0, force_suppress=True),
    dict(in_format="center", out_format="corner"),
    dict(in_format="corner", out_format="center", id_index=0),
], ids=["default", "valid_thresh", "topk", "id_index", "force_suppress",
        "center_in", "center_out"])
def test_box_nms_matches_jax(kw):
    data = _nms_rows(2, kw.get("in_format", "corner"))
    (got,), (ref,) = _both("box_nms", [data], **kw)
    g, r = _np(got), _np(ref)
    np.testing.assert_array_equal(g[..., 1] < 0, r[..., 1] < 0)
    np.testing.assert_array_equal(g[..., :2], r[..., :2])
    _close(got, ref, f"box_nms {kw}")
    assert (r[..., 1] < 0).any() and (r[..., 1] >= 0).any()


def test_box_iou_formats_match_jax():
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, (2, 5)), _boxes(rng, (2, 7))
    for fmt in ("corner", "center"):
        (got,), (ref,) = _both("box_iou", [a, b], format=fmt)
        _close(got, ref, fmt)


# ------------------------------------------------------ bipartite_matching
@pytest.mark.parametrize("kw", [
    dict(), dict(is_ascend=True, threshold=0.6), dict(topk=2),
    dict(threshold=0.5)], ids=["default", "ascend", "topk", "threshold"])
def test_bipartite_matching_matches_jax(kw):
    rng = np.random.RandomState(5)
    dist = rng.randint(0, 8, (3, 6, 4)).astype(np.float32) / 8   # ties
    got, ref = _both("bipartite_matching", [dist], **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), _np(r))
    got2, ref2 = _both("bipartite_matching", [dist[0]], **kw)   # 2-D input
    for g, r in zip(got2, ref2):
        np.testing.assert_array_equal(_np(g), _np(r))


# ------------------------------------------------------ ROIAlign / Pooling
_ROIS = np.array([[0, -3.0, -2.0, 5.0, 6.0],       # past the top left
                  [1, 10.0, 12.0, 19.0, 17.0],     # past the bottom right
                  [0, 2.5, 3.0, 9.5, 8.0],         # inside
                  [1, -6.0, 4.0, -1.0, 9.0],       # outside, left
                  [0, 4.0, 4.0, 4.0, 4.0]], np.float32)   # empty


@pytest.mark.parametrize("name,kw", [
    ("ROIAlign", dict(pooled_size=(3, 3), spatial_scale=0.75)),
    ("ROIAlign", dict(pooled_size=2, spatial_scale=1.0, sample_ratio=3)),
    ("ROIPooling", dict(pooled_size=(3, 2), spatial_scale=0.75)),
], ids=["align", "align_ratio3", "pooling"])
def test_roi_ops_match_jax_outside_the_image(name, kw):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 12, 13).astype(np.float32)
    cot_rng = np.random.RandomState(7)
    res = {}
    for pkg in (mx, mxj):
        with pkg.cpu():
            data = pkg.nd.array(x)
            rois = pkg.nd.array(_ROIS)
        data.attach_grad()
        rois.attach_grad()
        with pkg.autograd.record():
            out = getattr(pkg.nd, name)(data, rois, **kw)
        cot = cot_rng.randn(*out.shape).astype(np.float32)
        cot_rng.seed(7)
        out.backward(pkg.nd.array(cot, ctx=pkg.cpu()))
        res[pkg] = (out, data.grad, rois.grad)
    _close(res[mx][0], res[mxj][0], f"{name} forward")
    _close(res[mx][1], res[mxj][1], f"{name} data gradient", rtol=1e-5)
    _close(res[mx][2], res[mxj][2], f"{name} rois gradient", rtol=1e-5)
    assert np.abs(_np(res[mxj][0])[3]).max() == 0 or name == "ROIPooling"


def test_roi_align_chunks_match_one_piece(monkeypatch):
    """RoIs worked through in chunks give the one-piece result."""
    from incubator_mxnet_torch.ops import contrib
    rng = np.random.RandomState(8)
    x = rng.randn(2, 4, 10, 10).astype(np.float32)
    rois = np.concatenate([rng.randint(0, 2, (37, 1)),
                           _boxes(rng, (37,), 0, 8, 1, 5)], 1) \
        .astype(np.float32)
    with mx.cpu():
        whole = nd.ROIAlign(nd.array(x), nd.array(rois), pooled_size=3)
        monkeypatch.setattr(contrib, "ROI_CHUNK_BYTES", 3 * 3 * 4 * 4 * 4 * 5)
        parts = nd.ROIAlign(nd.array(x), nd.array(rois), pooled_size=3)
    np.testing.assert_array_equal(parts.asnumpy(), whole.asnumpy())


# ----------------------------------------------------------------- TinySSD
def _example():
    spec = importlib.util.spec_from_file_location("train_ssd", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


IMG = 32
SIZES, RATIOS = (0.3, 0.45, 0.6), (1.0, 1.5)


def make_batch(batch, rng):
    """The example's `make_batch` in numpy: images (B, 1, 32, 32) and
    labels (B, 1, 5) [cls, x1, y1, x2, y2] normalized."""
    X = rng.rand(batch, 1, IMG, IMG).astype(np.float32) * 0.3
    L = np.zeros((batch, 1, 5), np.float32)
    for i in range(batch):
        w = rng.randint(8, 17)
        h = rng.randint(8, 17)
        x1 = rng.randint(0, IMG - w)
        y1 = rng.randint(0, IMG - h)
        X[i, 0, y1:y1 + h, x1:x1 + w] += 1.0
        L[i, 0] = [0, x1 / IMG, y1 / IMG, (x1 + w) / IMG, (y1 + h) / IMG]
    return X, L


class TinySSD(gluon.nn.HybridBlock):
    """The example's TinySSD written against the port."""

    def __init__(self, num_anchors, **kw):
        super().__init__(**kw)
        self.backbone = gluon.nn.HybridSequential()
        for ch in (16, 32, 64):
            self.backbone.add(
                gluon.nn.Conv2D(ch, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(2))
        self.cls_head = gluon.nn.Conv2D(num_anchors * 2, 3, padding=1)
        self.box_head = gluon.nn.Conv2D(num_anchors * 4, 3, padding=1)

    def hybrid_forward(self, F, x):
        feat = self.backbone(x)
        cls = self.cls_head(feat)
        box = self.box_head(feat)
        cls = F.reshape(F.transpose(cls, axes=(0, 2, 3, 1)), shape=(0, -1, 2))
        box = F.reshape(F.transpose(box, axes=(0, 2, 3, 1)), shape=(0, -1))
        return feat, cls, box


def _ssd_steps(pkg, net, batches, steps):
    """The example's loop for `steps` batches: (anchors, per-step losses
    and targets, detections of the last batch after training)."""
    nd_ = pkg.nd
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 2e-3})
    cls_loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    box_loss = pkg.gluon.loss.HuberLoss()
    anchors, losses, targets = None, [], []
    with pkg.cpu():
        for X, L in batches[:steps]:
            X, L = nd_.array(X), nd_.array(L)
            if anchors is None:
                feat, _, _ = net(X)
                anchors = nd_.contrib.MultiBoxPrior(feat, sizes=SIZES,
                                                    ratios=RATIOS)
            with pkg.autograd.record():
                _, cls_pred, box_pred = net(X)
                bt, bm, ct = nd_.contrib.MultiBoxTarget(
                    anchors, L, nd_.transpose(cls_pred, axes=(0, 2, 1)))
                lc = cls_loss(cls_pred, ct)
                lb = box_loss(box_pred * bm, bt * bm)
                loss = lc.mean() + lb.mean()
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
            targets.append([_np(t) for t in (bt, bm, ct)])
        X, _ = batches[-1]
        _, cls_pred, box_pred = net(nd_.array(X))
        probs = nd_.softmax(nd_.transpose(cls_pred, axes=(0, 2, 1)), axis=1)
        det = nd_.contrib.MultiBoxDetection(probs, box_pred, anchors,
                                            threshold=0.1,
                                            nms_threshold=0.45)
    return _np(anchors), losses, targets, _np(det)


def test_tiny_ssd_five_adam_steps_match_jax():
    ex = _example()
    rng = np.random.RandomState(0)
    batches = [make_batch(32, rng) for _ in range(6)]
    ex_rng = np.random.RandomState(0)
    X0, L0 = ex.make_batch(32, ex_rng)                 # the example's data
    np.testing.assert_array_equal(X0.asnumpy(), batches[0][0])
    np.testing.assert_array_equal(L0.asnumpy(), batches[0][1])
    num_anchors = len(SIZES) + len(RATIOS) - 1
    mxj.random.seed(0)
    jnet = ex.TinySSD(num_anchors)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jnet(mxj.nd.array(batches[0][0], ctx=mxj.cpu()))
    tnet = TinySSD(num_anchors)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    assert sorted(weights) == sorted(tnet._collect_params_with_prefix())
    params_from_jax(tnet, weights)
    ref = _ssd_steps(mxj, jnet, batches, 5)
    got = _ssd_steps(mx, tnet, batches, 5)
    _close(mx.nd.array(got[0], ctx=mx.cpu()),
           mxj.nd.array(ref[0]), "anchors")
    for step, (g, r) in enumerate(zip(got[2], ref[2])):
        for name, a, b in zip(("box target", "mask", "class"), g, r):
            if name == "box target":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                           err_msg=f"step {step} {name}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=0)
    assert got[1][-1] < got[1][0]
    g, r = got[3], ref[3]
    np.testing.assert_array_equal(g[..., 0], r[..., 0])
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
