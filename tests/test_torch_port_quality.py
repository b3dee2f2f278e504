"""The port's quality scorer (``utils/quality.py``) against the JAX
package's, on the CPU through the plain MLP path.

- With the classifier the reference trains (300 steps on 2000 synthetic
  digits), carried to the port as numpy: ``classifier_accuracy`` within
  one prediction of 400 (a test image whose two top logits lie within
  float32 rounding of each other may go either way), ``score_samples``
  by rtol 1e-4 on real, noise and collapsed samples (a softmax over ten
  classes and means over 400 rows in float32, summed in another order:
  1e-5 of rounding at most was seen), and ``fid_score`` by rtol 1e-5
  (float32 features, float64 statistics; 8e-8 was seen).
- One Adam step of the port's classifier on a batch of 256 against
  ``jax.grad`` of the reference's loss and ``optax.adam(1e-3)``: the loss
  by rtol 1e-6, every gradient by max abs error over its max |g| at
  1e-5 (float32 sums of 256 rows in another order), the new parameters
  by atol 1e-7 wherever |g| >= 1e-6 (there Adam's first step is lr times
  g / (|g| + 1e-8), which rounding in g moves far below 1e-7) and by lr
  elsewhere (near |g| ~ eps the step is set by rounding, and either
  side's step is at most lr).
- A classifier the port trains itself passes the reference test's
  thresholds (tests/test_quality.py): test accuracy > 0.9, real samples'
  class entropy > 2 and IS > 3, a collapsed sample's entropy < 0.5 and
  IS < 1.5, noise less confident than real data, and FID ordering.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generative_models_tpu.data.mnist import synthetic_mnist, to_flat_float
from generative_models_tpu.models.mlp import mlp_apply_xla, mlp_init
from generative_models_tpu.utils import quality as ref
from generative_models_tpu_torch.utils import quality as port
from generative_models_tpu_torch.utils.checkpoint import params_from_numpy
from generative_models_tpu_torch.utils.tree import tree_map


@pytest.fixture(scope="module")
def digits():
    return to_flat_float(synthetic_mnist(2000, 400, seed=0))


@pytest.fixture(scope="module")
def jax_clf(digits):
    return ref.train_classifier(digits["x_train"], digits["y_train"],
                                steps=300)


def _carry(jax_params):
    return params_from_numpy(jax.tree_util.tree_map(np.array, jax_params))


def _fakes(digits):
    x = digits["x_test"]
    noise = np.random.default_rng(0).random((400, 784), dtype=np.float32)
    return {"real": x, "noise": noise,
            "collapsed": np.tile(x[:1], (400, 1))}


def test_accuracy_matches_the_reference(digits, jax_clf):
    x, y = digits["x_test"], digits["y_test"]
    a = ref.classifier_accuracy(jax_clf, x, y)
    b = port.classifier_accuracy(_carry(jax_clf), x, y)
    assert abs(a - b) <= 1.0 / len(y) + 1e-12


@pytest.mark.parametrize("kind", ["real", "noise", "collapsed"])
def test_scores_and_fid_match_the_reference(digits, jax_clf, kind):
    fake = _fakes(digits)[kind]
    clf = _carry(jax_clf)
    a, b = ref.score_samples(jax_clf, fake), port.score_samples(clf, fake)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4)
    real = digits["x_test"][:200]
    np.testing.assert_allclose(port.fid_score(clf, real, fake[200:]),
                               ref.fid_score(jax_clf, real, fake[200:]),
                               rtol=1e-5)


def test_one_adam_step_matches_jax_grad_and_optax(digits):
    xb, yb = digits["x_train"][:256], digits["y_train"][:256]

    def loss_fn(p, xb, yb):
        logits = mlp_apply_xla(p, xb, hidden_act="relu", out_act="none")
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, yb))

    p0 = mlp_init(jax.random.PRNGKey(1), [784, 128, 10])
    loss = loss_fn(p0, xb, yb)
    g = jax.grad(loss_fn)(p0, xb, yb)
    tx = optax.adam(port.LR)
    updates, _ = tx.update(g, tx.init(p0), p0)
    p1 = optax.apply_updates(p0, updates)

    tp0 = _carry(p0)
    opt = {"count": torch.zeros((), dtype=torch.int32),
           "mu": tree_map(torch.zeros_like, tp0),
           "nu": tree_map(torch.zeros_like, tp0)}
    xt, yt = torch.from_numpy(xb), torch.from_numpy(yb).long()
    leaves = [{k: t.clone().requires_grad_(True) for k, t in l.items()}
              for l in tp0]
    tg = torch.autograd.grad(port.classifier_loss(leaves, xt, yt),
                             [l[k] for l in leaves for k in ("b", "w")])
    tp1, opt1, tloss = port.classifier_step(tp0, opt, xt, yt)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    assert int(opt1["count"]) == 1
    for j, (i, k) in enumerate((i, k) for i in range(2) for k in ("b", "w")):
        gj = np.asarray(g[i][k])
        assert np.abs(tg[j].numpy() - gj).max() <= 1e-5 * np.abs(gj).max()
        d = np.abs(tp1[i][k].numpy() - np.asarray(p1[i][k]))
        big = np.abs(gj) >= 1e-6
        assert d[big].max(initial=0.0) <= 1e-7
        assert d.max() <= port.LR


def test_port_trained_classifier_passes_the_reference_thresholds(digits):
    clf = port.train_classifier(digits["x_train"], digits["y_train"],
                                steps=300, device="cpu")
    assert [tuple(l["w"].shape) for l in clf] == [(784, 128), (128, 10)]
    assert port.classifier_accuracy(clf, digits["x_test"],
                                    digits["y_test"]) > 0.9
    fakes = _fakes(digits)
    real = port.score_samples(clf, fakes["real"])
    assert real["class_entropy"] > 2.0 and real["is_score"] > 3.0
    col = port.score_samples(clf, fakes["collapsed"])
    assert col["class_entropy"] < 0.5 and col["is_score"] < 1.5
    assert port.score_samples(clf, fakes["noise"])["confidence"] < \
        real["confidence"]
    half_a, half_b = fakes["real"][:200], fakes["real"][200:]
    f_self = port.fid_score(clf, half_a, half_b)
    assert f_self >= 0.0
    assert port.fid_score(clf, half_a, fakes["collapsed"][:200]) > 5 * f_self
    assert port.fid_score(clf, half_a, fakes["noise"][:200]) > 5 * f_self
    assert port.fid_score(clf, half_a, half_a) < 1e-6


def test_training_is_a_function_of_the_generator(digits):
    x, y = digits["x_train"][:512], digits["y_train"][:512]
    a = port.train_classifier(x, y, torch.Generator().manual_seed(3),
                              steps=5, batch=32, device="cpu")
    b = port.train_classifier(x, y, torch.Generator().manual_seed(3),
                              steps=5, batch=32, device="cpu")
    c = port.train_classifier(x, y, torch.Generator().manual_seed(4),
                              steps=5, batch=32, device="cpu")
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, b) for k in p)
    assert not torch.equal(a[0]["w"], c[0]["w"])
