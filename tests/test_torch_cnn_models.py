"""The paper's CNNs in the port (``repro_torch.models.cnn``) against the
JAX package's (``repro.models.cnn``), on the CPU, at the paper's full
widths: the same weights (made by the JAX package, carried across as numpy
through ``checkpoint.bridge.params_from_numpy``, HWIO filters unchanged)
and the same NHWC images from a numpy seed.

Tolerances, with their reasons:
- logits (f32, batch 2) within 1e-5 of the largest |logit|: XLA's and
  torch's CPU convolutions sum the same f32 products in another order;
- every parameter gradient of ``softmax_xent`` within 1e-4 of its leaf's
  largest |g|: the same sums, through the backward of up to 31 layers.
The gradient cases cover what the layout change could break: LeNet-5's
and AlexNet's fc1 read the flatten in the reference's (h, w, c) order,
AlexNet's grouped convs split channels as ``feature_group_count`` does,
and ResNet-32's stride-2 3x3 convs pad as JAX's asymmetric SAME. VGG16's
ops are a subset of these, so it is held by its forward only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.train.losses import softmax_xent as jxent
from repro_torch.core import metrics
from repro_torch.models import cnn
from repro_torch.train.cnn import loss_and_grads
from test_torch_train import _flat_np, _jflat_np
from torch_parity import to_port

LOGIT_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the reference module docstring's totals, and the paper's layer-wise
# counts (Tables A1-A4)
TOTALS = {"lenet5": 430_500, "alexnet-cifar": 7_558_176,
          "vgg16-cifar": 16_293_568, "resnet32-cifar": 464_432}
LAYERS = {
    "lenet5": {"conv1": 500, "conv2": 25_000, "fc1": 400_000, "fc2": 5_000},
    "alexnet-cifar": {"conv1": 7_200, "conv2": 307_200, "conv3": 884_736,
                      "conv4": 663_552, "conv5": 442_368, "fc1": 4_194_304,
                      "fc2": 1_048_576, "fc3": 10_240},
    "vgg16-cifar": {"conv1-1": 1_728, "conv1-2": 36_864, "conv2-1": 73_728,
                    "conv2-2": 147_456, "conv3-1": 294_912,
                    "conv3-2": 589_824, "conv3-3": 589_824,
                    "conv4-1": 1_179_648, "conv4-2": 2_359_296,
                    "conv4-3": 2_359_296, "conv5-1": 2_359_296,
                    "conv5-2": 2_359_296, "conv5-3": 2_359_296,
                    "fc1": 524_288, "fc2": 1_048_576, "fc3": 10_240},
    "resnet32-cifar": None,     # 34 leaves: held by the total and per leaf
}
# leaves (weights and biases) each prox-Adam step updates, one launch each
LEAVES = {"lenet5": 6, "alexnet-cifar": 11, "vgg16-cifar": 19,
          "resnet32-cifar": 35}


@pytest.fixture(scope="module")
def nets():
    return {}


def _pair(name, cache):
    """(JAX model, JAX params, port model, port params), made once."""
    if name not in cache:
        jm = jcnn.CNN_ZOO[name]
        jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
        cache[name] = (jm, jp, cnn.CNN_ZOO[name], to_port(jp))
    return cache[name]


def _images(model, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + model.input_shape).astype(np.float32)
    y = rng.integers(0, model.n_classes, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", list(TOTALS))
def test_forward_matches_jax(name, nets):
    jm, jp, tm, tp = _pair(name, nets)
    x, _ = _images(tm)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["lenet5", "alexnet-cifar",
                                  "resnet32-cifar"])
def test_param_grads_match_jax(name, nets):
    jm, jp, tm, tp = _pair(name, nets)
    x, y = _images(tm, n=4, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jxent(jm.apply(p, jnp.asarray(x)), jnp.asarray(y))))(jp)
    tl, tg = loss_and_grads(tm, tp, {"inputs": torch.from_numpy(x),
                                     "labels": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want, got = _jflat_np(jg), _flat_np(tg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", list(TOTALS))
def test_weight_counts(name, nets):
    jm, jp, tm, tp = _pair(name, nets)
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert cnn.weight_count(own) == cnn.weight_count(tp) == TOTALS[name] \
        == jcnn.weight_count(jp)
    assert len(_flat_np(own)) == LEAVES[name]
    table = metrics.layer_compression(own)
    assert sum(v["total"] for v in table.values()) == TOTALS[name]
    assert {k: v.shape for k, v in _flat_np(own).items()} == \
        {k: v.shape for k, v in _jflat_np(jp).items()}
    if LAYERS[name]:
        per_layer = {k.split("'")[1]: v["total"] for k, v in table.items()}
        assert per_layer == LAYERS[name]


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (16, 3, 2), (32, 1, 2),
                                   (32, 3, 1), (28, 5, 1), (7, 3, 2),
                                   (8, 4, 3)])
def test_same_padding_matches_lax(n, k, s):
    """``conv``'s SAME pads are ``lax.padtype_to_pads``', also where they
    are asymmetric (32 -> 16 and 16 -> 8 with a 3x3 stride-2 filter)."""
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert cnn._same_pads(n, k, s) == tuple(want)


def test_conv_strided_same_matches_jax():
    """One stride-2 SAME conv, the case where F.conv2d(padding=1) would
    shift every output."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)
    want = np.asarray(jcnn.conv(jnp.asarray(x), jnp.asarray(w), stride=2))
    got = cnn.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w), stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
