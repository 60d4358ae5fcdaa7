"""Ditto on the port against the JAX package: ``projects/ditto.py``,
``projects/senteval_classifier.py`` and ``cli/run_ditto.py``. JAX is
imported inside the tests.

Sizes: a BERT of width 32, 2 layers, 2 heads, vocabulary 300, with a
pooler; batches of 4 sentences of at most 12 tokens (one padded). Weights
come from Flax's init and load with ``strict=True``. Tolerances (float32,
sums in another order): every pooler's embeddings 2e-5; the attention
diagonal 2e-6 against JAX and 1e-6 against a float64 recompute; STS
Spearman 1e-6; the relatedness regression's Pearson, Spearman and MSE 1e-4
relative (60 full-batch Adam steps; run_ditto's 300 in the CLI test). STS, the regression and the probes
see the same embeddings in both packages (the port's; the embeddings
themselves are held to JAX's above), so the probes' accuracies and chosen
regularisers are equal, and the SentEval MLP's fitted weights agree within
1e-4; run_ditto end to end 1e-5 on every number.
"""

import functools
import json
from unittest import mock

import numpy as np
import pytest
import torch

ENC = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=64, add_pooler=True)
L = 12


def _tokenize(sentences):
    ids = np.zeros((len(sentences), L), np.int32)
    mask = np.zeros((len(sentences), L), np.int32)
    for i, s in enumerate(sentences):
        toks = [101] + [5 + sum(map(ord, w)) % 290 for w in s.split()][: L - 1]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return ids, mask


@functools.lru_cache(maxsize=1)
def _models():
    """(JAX encoder, its params, the port's encoder carrying them)."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.models.encoder import Encoder as JEncoder
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.encoder import Encoder

    jenc = JEncoder(JEnc(**ENC))
    params = jax.jit(lambda k: jenc.init(k, jnp.ones((1, L), jnp.int32))["params"])(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    tenc = Encoder(EncoderConfig(**ENC))
    tenc.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jenc, params, tenc.eval()


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 299, size=(4, L)).astype(np.int32)
    mask = np.ones((4, L), np.int32)
    mask[2, 9:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


LAYER, HEAD = 1, 1


@functools.lru_cache(maxsize=1)
def _jax_embeddings():
    """Every pooler's JAX embeddings of one batch, in one compiled call."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.projects import ditto as jd

    jenc, params, _ = _models()
    fns = {p: jd.make_embed_fn(jenc, params, p, LAYER, HEAD) for p in jd.POOLERS}
    ids, mask = _batch()
    out = jax.jit(lambda i, m: {p: f(i, m) for p, f in fns.items()})(jnp.asarray(ids),
                                                                      jnp.asarray(mask))
    return {p: np.asarray(v) for p, v in out.items()}


@pytest.mark.parametrize("pooler", ["cls", "cls_before_pooler", "avg", "avg_top2",
                                    "avg_first_last", "att_first_last", "att_last",
                                    "att_static", "avg_static"])
def test_every_pooler_matches_jax(pooler):
    from spokennlp_tpu_torch.projects import ditto as td

    assert pooler in td.POOLERS
    _, _, tenc = _models()
    got = td.make_embed_fn(tenc, pooler, LAYER, HEAD)(*_batch())
    np.testing.assert_allclose(got.numpy(), _jax_embeddings()[pooler], atol=2e-5, rtol=2e-5)


def test_attention_diagonal_matches_jax_and_float64():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.projects import ditto as jd
    from spokennlp_tpu_torch.projects import ditto as td

    jenc, params, tenc = _models()
    ids, mask = _batch()
    with torch.no_grad():
        hs = tenc(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                  output_hidden_states=True).hidden_states[LAYER]
        got = td.attention_diagonal(tenc, hs, torch.from_numpy(mask), LAYER, HEAD).numpy()
    want = jax.jit(lambda h, m: jd.attention_diagonal(jenc, params, h, m, LAYER, HEAD))(
        jnp.asarray(hs.numpy()), jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6, rtol=2e-6)

    # float64: exp(s_ii - logsumexp_j s_ij) over the real keys, which on a
    # real token is its softmax row's diagonal
    h = hs.numpy().astype(np.float64)
    attn = params[f"layer_{LAYER}"]["attention"]["qkv"]
    k_, b_ = attn["kernel"].astype(np.float64), attn["bias"].astype(np.float64)
    q = h @ k_[:, 0, HEAD] + b_[0, HEAD]
    k = h @ k_[:, 1, HEAD] + b_[1, HEAD]
    s = q @ k.transpose(0, 2, 1) / np.sqrt(16)
    sm = s + (1.0 - mask[:, None, :]) * -1e9
    lse = sm.max(-1) + np.log(np.exp(sm - sm.max(-1, keepdims=True)).sum(-1))
    want64 = np.exp(np.diagonal(s, axis1=1, axis2=2) - lse)
    np.testing.assert_allclose(got, want64, atol=1e-6, rtol=1e-5)
    p = np.exp(sm - lse[..., None])
    real = mask == 1
    np.testing.assert_allclose(got[real], np.diagonal(p, axis1=1, axis2=2)[real], atol=1e-6)


def _sentences(n, seed):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]
    return [" ".join(rng.choice(words, size=int(rng.integers(2, 10)))) for _ in range(n)]


def _embed_fns():
    """The port's embed fn, and JAX's: a JAX-side fn that returns the
    port's embeddings (the probes and STS see the same inputs)."""
    from spokennlp_tpu_torch.projects import ditto as td

    _, _, tenc = _models()
    port = td.make_embed_fn(tenc, "att_first_last", LAYER, HEAD)
    return port, lambda ids, mask: port(np.array(ids), np.array(mask)).numpy()


def test_evaluate_sts_and_relatedness_match_jax(tmp_path):
    from spokennlp_tpu.projects import ditto as jd
    from spokennlp_tpu_torch.projects import ditto as td

    a, b = _sentences(10, 1), _sentences(10, 2)
    gold = np.random.default_rng(3).uniform(0, 5, size=10).round(2)
    (tmp_path / "sts.tsv").write_text(
        "\n".join(f"{x}\t{y}\t{g}" for x, y, g in zip(a, b, gold)))
    ds_j, ds_t = (m.load_sts_tsv(str(tmp_path / "sts.tsv")) for m in (jd, td))
    port, jax_side = _embed_fns()
    want = jd.evaluate_sts(jax_side, _tokenize, ds_j, batch_size=4)
    got = td.evaluate_sts(port, _tokenize, ds_t, batch_size=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)

    data = {"train": (_sentences(12, 4), _sentences(12, 5),
                      list(np.random.default_rng(6).uniform(1, 5, size=12).round(1))),
            "test": (a, b, list(1 + gold * 0.8))}
    kw = dict(batch_size=4, epochs=60)
    want = jd.evaluate_similarity_regression(jax_side, _tokenize, data, **kw)
    got = td.evaluate_similarity_regression(port, _tokenize, data, device="cpu", **kw)
    for k in ("pearson", "spearman", "mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def _tasks():
    labels = lambda n, s: list(np.random.default_rng(s).integers(0, 2, size=n))
    return {
        "split": {"train": (_sentences(24, 7), labels(24, 8)),
                  "dev": (_sentences(10, 9), labels(10, 10)),
                  "test": (_sentences(10, 11), labels(10, 12))},
        "folds": {"all": (_sentences(30, 13), labels(30, 14))},
    }


@pytest.mark.parametrize("classifier", ["logreg", "mlp"])
def test_transfer_probes_match_jax(classifier):
    """The logreg probe (sklearn, a dev split and 3 folds) and the SentEval
    MLP probe (a dev split; the l2 grid of four fits) over the same
    embeddings: accuracies and chosen regularisers equal; the MLP's fitted
    weights within 1e-4 of JAX's."""
    from spokennlp_tpu.projects import ditto as jd
    from spokennlp_tpu.projects import senteval_classifier as jsc
    from spokennlp_tpu_torch.projects import ditto as td
    from spokennlp_tpu_torch.projects import senteval_classifier as tsc

    port, jax_side = _embed_fns()
    tasks = _tasks() if classifier == "logreg" else {"split": _tasks()["split"]}
    fits = {"j": [], "t": []}

    def keep(side, real):
        def fit(*a, **kw):
            out = real(*a, **kw)
            fits[side].append(out[0])
            return out
        return fit

    with mock.patch.object(jsc, "fit_with_reg_grid", keep("j", jsc.fit_with_reg_grid)), \
            mock.patch.object(tsc, "fit_with_reg_grid", keep("t", tsc.fit_with_reg_grid)):
        kw = dict(batch_size=8, kfold=3, classifier=classifier)
        want = jd.evaluate_transfer_classification(jax_side, _tokenize, tasks, **kw)
        got = td.evaluate_transfer_classification(port, _tokenize, tasks, device="cpu", **kw)
    assert got == want
    for jclf, tclf in zip(fits["j"], fits["t"]):
        for k, v in tclf.model.state_dict().items():
            layer, leaf = k.split(".")
            np.testing.assert_allclose(v.numpy(), np.asarray(jclf.params[layer][leaf]),
                                       atol=1e-4, err_msg=k)


def test_run_ditto_matches_jax(tmp_path):
    """run_ditto on a tiny native checkpoint (both packages' tokenizer
    resolution patched to one word hash inside the vocabulary): STS, the
    probing task (logreg) and the relatedness regression equal JAX's; the
    cls pooler on a checkpoint without pooler weights raises; the CLI
    defaults to the card."""
    import jax.numpy as jnp  # noqa: F401  (JAX's CLI below)

    from spokennlp_tpu.cli import common as jcommon
    from spokennlp_tpu.cli import run_ditto as jcli
    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.models import checkpoint_io
    from spokennlp_tpu_torch.cli import common as tcommon
    from spokennlp_tpu_torch.cli import run_ditto as tcli

    _, params, _ = _models()
    ckpt = tmp_path / "ckpt"
    checkpoint_io.save_checkpoint(str(ckpt), params, JEnc(**ENC))
    bare = tmp_path / "bare"
    checkpoint_io.save_checkpoint(str(bare), {k: v for k, v in params.items() if k != "pooler"},
                                  JEnc(**{**ENC, "add_pooler": False}))
    a, b = _sentences(9, 15), _sentences(9, 16)
    (tmp_path / "sts.tsv").write_text("\n".join(
        f"{x}\t{y}\t{g}" for x, y, g in zip(a, b, np.linspace(0, 5, 9))))
    rel = tmp_path / "rel"
    rel.mkdir()
    for name, seed in (("train.tsv", 17), ("test.tsv", 18)):
        s1, s2 = _sentences(8, seed), _sentences(8, seed + 10)
        scores = np.random.default_rng(seed).uniform(1, 5, size=8).round(1)
        (rel / name).write_text("\n".join(f"{g}\t{x}\t{y}" for g, x, y in zip(scores, s1, s2)))
    rows = [f"{split}\t{lab}\t{s}" for split, n in (("tr", 20), ("va", 8), ("te", 8))
            for lab, s in zip(np.random.default_rng(n).integers(0, 2, size=n), _sentences(n, n))]
    (tmp_path / "bigram_shift.txt").write_text("\n".join(rows))
    argv = ["--model_name_or_path", str(ckpt), "--pooler", "att_first_last", "--layer", "1",
            "--head", "1", "--max_seq_length", "12", "--batch_size", "4",
            "--sts_tsv", str(tmp_path / "sts.tsv"), "--relatedness_dir", str(rel),
            "--probing_files", str(tmp_path / "bigram_shift.txt")]
    tok = (lambda s: [5 + sum(map(ord, w)) % 290 for w in s.split()],
           {"cls": 101, "pad": 0, "bos": 1, "sep": 102, "vocab_size": 300})
    with mock.patch.object(jcommon, "resolve_tokenizer", lambda ns: tok):
        want = jcli.main(argv + ["--output_dir", str(tmp_path / "j")])
    with mock.patch.object(tcommon, "resolve_tokenizer", lambda ns: tok):
        got = tcli.main(argv + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert set(got) == set(want) == {"sts", "relatedness", "probing"}
    assert got["probing"] == want["probing"]
    for group in ("sts", "relatedness"):
        for k in want[group]:
            np.testing.assert_allclose(got[group][k], want[group][k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{group}.{k}")
    assert json.loads((tmp_path / "t" / "ditto_results.json").read_text())["sts"]
    with pytest.raises(ValueError, match="pooler weights"):
        tcli.main(["--model_name_or_path", str(bare), "--output_dir", str(tmp_path / "x"),
                   "--pooler", "cls", "--device", "cpu"])
    assert tcli.make_parser().parse_args(["--model_name_or_path", "m", "--output_dir",
                                          "o"]).device == "cuda"


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_embeddings_run_kernels_1_and_2_on_card(cuda):
    """BERT-base widths (2 layers) at Ditto's B = 32, L = 128: one batch
    launches the fused attention and MLP kernels once a layer, and every
    pooler agrees with the einsum path with the kernels' tanh GELU within
    1e-4 of its largest value."""
    import dataclasses

    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.encoder import Encoder
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.projects import ditto as td

    cfg = EncoderConfig(vocab_size=512, num_layers=2, add_pooler=True)
    enc = Encoder(cfg, generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    twin = Encoder(dataclasses.replace(cfg, attention_impl="einsum", hidden_act="gelu_new"))
    twin.load_state_dict(enc.state_dict(), strict=True)
    twin = twin.to(cuda).eval()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(5, 512, size=(32, 128))).to(cuda)
    mask = torch.ones_like(ids)
    for b in range(32):
        mask[b, 8 + 3 * b:] = 0
    n1, n2 = fused_attention_block.launches, fused_mlp_block.launches
    td.make_embed_fn(enc, "att_first_last", 0, 9)(ids, mask)
    assert (fused_attention_block.launches - n1, fused_mlp_block.launches - n2) == (2, 2)
    for pooler in td.POOLERS:
        got = td.make_embed_fn(enc, pooler, 0, 9)(ids, mask)
        want = td.make_embed_fn(twin, pooler, 0, 9)(ids, mask)
        err = (got - want).abs().max().item() / want.abs().max().item()
        assert err <= 1e-4, (pooler, err)
