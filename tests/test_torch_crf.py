"""The port's linear-chain CRF (``ops/crf.py``) against the JAX package's.

Sizes: B=5, L=12, T=3 (the tagger's BIO tags) and T=5. The masks hold a
full row, suffix-padded rows, a row whose only valid position is 0, a fully
masked row (position 0 masked too: the scan still starts from its first
emissions) and a row with a hole. The log-likelihood and its gradient with
respect to emissions and transitions agree within 1e-5 (float32 sums in
another order); Viterbi tags are equal and scores agree within 1e-5, also
on integer-valued emissions with zero transitions, where many paths tie
exactly and the first maximal index must win.
"""

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops import crf

B, L = 5, 12


def _mask():
    m = np.ones((B, L), np.int32)
    m[1, 7:] = 0
    m[2, 1:] = 0  # only position 0
    m[3, :] = 0  # fully masked, position 0 included
    m[4, 4:6] = 0  # a hole
    return m


def _inputs(T, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        em = rng.integers(-1, 2, size=(B, L, T)).astype(np.float32)
        tr = np.zeros((T, T), np.float32)
    else:
        em = rng.normal(size=(B, L, T)).astype(np.float32)
        tr = rng.normal(size=(T, T)).astype(np.float32)
    tags = rng.integers(0, T, size=(B, L)).astype(np.int32)
    return em, tags, _mask(), tr


@pytest.mark.parametrize("T", [3, 5])
def test_log_likelihood_and_gradient_match_jax(T):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops import crf as jcrf

    em, tags, mask, tr = _inputs(T)
    jfn = lambda e, t: jcrf.crf_log_likelihood(e, jnp.asarray(tags), jnp.asarray(mask), t)
    want, (jge, jgt) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(em), jnp.asarray(tr))
    e = torch.from_numpy(em).requires_grad_()
    t = torch.from_numpy(tr).requires_grad_()
    got = crf.crf_log_likelihood(e, torch.from_numpy(tags), torch.from_numpy(mask), t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,ties", [(3, False), (5, False), (3, True), (5, True)])
def test_viterbi_matches_jax(T, ties):
    import jax.numpy as jnp

    from spokennlp_tpu.ops import crf as jcrf

    em, _, mask, tr = _inputs(T, seed=1, ties=ties)
    jt, js = jcrf.crf_viterbi_decode(jnp.asarray(em), jnp.asarray(mask), jnp.asarray(tr))
    tt, ts = crf.crf_viterbi_decode(torch.from_numpy(em), torch.from_numpy(mask),
                                    torch.from_numpy(tr))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    if ties:  # exact ties did occur: two tags share a position's best emission
        top = np.sort(em, -1)
        assert (top[..., -1] == top[..., -2]).any()


def test_viterbi_path_scores_its_best_score():
    """The decoded path's own score (emissions + transitions over valid
    positions) is the returned best score, on rows whose mask is a prefix."""
    em, _, mask, tr = _inputs(4, seed=2)
    prefix = np.array([0, 1, 2])
    tags, score = crf.crf_viterbi_decode(torch.from_numpy(em), torch.from_numpy(mask),
                                         torch.from_numpy(tr))
    own = crf._sequence_score(torch.from_numpy(em), tags, torch.from_numpy(mask),
                              torch.from_numpy(tr))
    np.testing.assert_allclose(own.numpy()[prefix], score.numpy()[prefix], rtol=1e-6, atol=1e-5)
