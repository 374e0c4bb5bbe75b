"""Port parity: the i-vector logistic regression
(kaldi_tpu_torch.ivector.logistic_regression) against kaldi_tpu's, on the
CPU: JAX trains full-batch Adam steps with optax under jit, the port the
same steps with torch autograd and its own `optim.adam`, both in f32.
Weights and the final loss within 1e-5 after 100 steps, the same
classes; the host scoring (`log_posteriors`, `classify`, `scale_priors`)
equal to JAX's exactly on the same weights (`logistic_regression_from_jax`).
"""

import numpy as np
import pytest

from kaldi_tpu.ivector import logistic_regression as jlr
from kaldi_tpu_torch.ivector import logistic_regression as tlr
from kaldi_tpu_torch.params import logistic_regression_from_jax


def _data(seed, N=120, D=6, C=4):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, C, N)
    centers = rng.randn(C, D) * 1.5
    return centers[labels] + rng.randn(N, D), labels


@pytest.mark.parametrize("seed,cfg", [
    (0, dict()), (1, dict(normalizer=0.01, learning_rate=0.1)),
    (2, dict(max_steps=30))])
def test_train_equals_jax(seed, cfg):
    X, y = _data(seed)
    j, t = jlr.LogisticRegression(), tlr.LogisticRegression()
    lj = j.train(X, y, jlr.LogisticRegressionConfig(**cfg))
    lt = t.train(X, y, tlr.LogisticRegressionConfig(**cfg), device="cpu")
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(t.weights, j.weights, rtol=0, atol=1e-5)
    assert t.weights.dtype == np.float32
    np.testing.assert_array_equal(t.classify(X), j.classify(X))
    assert lt < np.log(4)


def test_no_steps_gives_the_zero_model_loss():
    X, y = _data(3)
    t = tlr.LogisticRegression()
    loss = t.train(X, y, tlr.LogisticRegressionConfig(max_steps=0),
                   device="cpu")
    np.testing.assert_allclose(loss, np.log(4), rtol=1e-6)
    assert not t.weights.any()


def test_scoring_equals_jax_on_carried_weights():
    X, y = _data(4)
    j = jlr.LogisticRegression()
    j.train(X, y)
    t = logistic_regression_from_jax(j)
    np.testing.assert_array_equal(t.log_posteriors(X), j.log_posteriors(X))
    np.testing.assert_array_equal(t.classify(X), j.classify(X))
    pri = np.log([0.1, 0.2, 0.3, 0.4])
    j.scale_priors(pri)
    t.scale_priors(pri)
    np.testing.assert_array_equal(t.weights, j.weights)
    np.testing.assert_array_equal(t.classify(X), j.classify(X))
