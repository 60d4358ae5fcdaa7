"""Gradient checkpointing in the port (``EncoderConfig.remat``,
``--gradient_checkpointing``) against JAX's ``nn.remat`` and against the
port without it.

- At dropout 0 the port with remat against JAX with remat, on
  tests/test_remat.py's two cases (dense, three layers; sliding window, two
  layers): every gradient within 1e-5 of the largest.
- At dropout 0.1 the port's remat gradients equal its own gradients without
  remat bit for bit, on every training path the CPU runs (einsum, the
  training kernels' plain versions, sliding window, BigBird), because each
  layer replays the generator state it had before the call.
- A checkpoint that draws again from the live generator in its recompute
  gets other masks: its gradients fail that gate.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models import encoder as encoder_mod
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.encoder import Encoder

GRAD_TOL = 1e-5  # of the largest gradient entry: float32 sums in another order

DENSE = dict(vocab_size=128, hidden_size=32, num_layers=3, num_heads=2, intermediate_size=64,
             max_position_embeddings=64, add_pooler=False)
SLIDING = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
               max_position_embeddings=128, add_pooler=False, attention_type="sliding_window",
               attention_window=32)
BIGBIRD = dict(DENSE, attention_type="bigbird", bigbird_block_size=16,
               max_position_embeddings=128)


def _case(name):
    """(config, ids, mask, global mask or None) of tests/test_remat.py's cases."""
    if name == "dense":
        rng = np.random.default_rng(0)
        ids = rng.integers(3, 127, size=(2, 32)).astype(np.int32)
        mask = np.ones((2, 32), np.int32)
        mask[1, 24:] = 0
        return DENSE, ids, mask, None
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 127, size=(1, 64)).astype(np.int32)
    gmask = np.zeros((1, 64), np.int32)
    gmask[:, 0] = 1
    return SLIDING, ids, np.ones((1, 64), np.int32), gmask


@pytest.mark.parametrize("case", ["dense", "sliding"])
def test_remat_gradients_match_jax(case):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.models.encoder import Encoder as JaxEncoder

    base, ids, mask, gmask = _case(case)
    cfg = EncoderConfig(**base, hidden_dropout=0.0, attention_dropout=0.0, remat=True,
                        attention_impl="einsum")
    jenc = JaxEncoder(JaxEncoderConfig(**dataclasses.asdict(cfg)))
    kw = dict(attention_mask=jnp.asarray(mask))
    if gmask is not None:
        kw["global_attention_mask"] = jnp.asarray(gmask)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids), **kw)["params"]
    # a fixed projection of the output: the sum of squares of a LayerNorm's
    # output hardly depends on its input
    proj = np.random.default_rng(3).normal(size=ids.shape + (cfg.hidden_size,))
    proj = proj.astype(np.float32)

    def loss_fn(p):
        out = jenc.apply({"params": p}, jnp.asarray(ids), deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(7)}, **kw)
        return jnp.sum(out.last_hidden_state.astype(jnp.float32) * proj)

    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jax.grad(loss_fn)(params)))

    port = Encoder(cfg).train()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    tkw = dict(attention_mask=torch.from_numpy(mask))
    if gmask is not None:
        tkw.update(global_attention_mask=torch.from_numpy(gmask), prefix_globals=1)
    out = port(torch.from_numpy(ids), generator=torch.Generator().manual_seed(0), **tkw)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad((out.last_hidden_state.float() * torch.from_numpy(proj)).sum(),
                                list(port.parameters()), allow_unused=True)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (name, np.abs(g - w).max(), scale)


PATHS = {
    "einsum": (DENSE, "einsum", 32),
    "train_fused": (DENSE, "train_fused", 32),
    "sliding": (SLIDING, "einsum", 128),
    "bigbird": (BIGBIRD, "einsum", 128),
}


def _dropout_grads(path, remat: bool):
    """Loss, gradients and the generator's end state of one training forward
    and backward at dropout 0.1, with or without remat."""
    base, impl, L = PATHS[path]
    cfg = EncoderConfig(**base, hidden_dropout=0.1, attention_dropout=0.1, attention_impl=impl,
                        remat=remat)
    port = Encoder(cfg, generator=torch.Generator().manual_seed(0)).train()
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(3, 127, size=(2, L)).astype(np.int32))
    mask = torch.ones((2, L), dtype=torch.int32)
    mask[1, L - 5:] = 0
    kw = {}
    if base.get("attention_type") == "sliding_window":
        gm = torch.zeros_like(mask)
        gm[:, 0] = 1
        kw = dict(global_attention_mask=gm, prefix_globals=1)
    gen = torch.Generator().manual_seed(11)
    out = port(ids, attention_mask=mask, generator=gen, **kw)
    proj = torch.randn(out.last_hidden_state.shape, generator=torch.Generator().manual_seed(3))
    loss = (out.last_hidden_state.float() * proj).sum()
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    return loss, [g for g in grads if g is not None], gen.get_state()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_remat_gradients_equal_plain_bit_for_bit_at_dropout(path):
    loss, grads, end = _dropout_grads(path, remat=False)
    loss_r, grads_r, end_r = _dropout_grads(path, remat=True)
    assert torch.equal(loss, loss_r)
    assert len(grads) == len(grads_r) > 0
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    # the step's generator continues where it would without remat
    assert torch.equal(end, end_r)


def _redrawing_checkpoint(fn, generator, *args, **kwargs):
    """The fault: the layer draws from the live generator, so the recompute
    inside the backward draws other masks than the forward did."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, generator=generator, use_reentrant=False, **kwargs)


@pytest.mark.parametrize("path", ["einsum", "train_fused"])
def test_redrawn_seeds_inside_the_checkpoint_fail_the_gate(path, monkeypatch):
    loss, grads, _ = _dropout_grads(path, remat=False)
    monkeypatch.setattr(encoder_mod, "checkpointed", _redrawing_checkpoint)
    loss_r, grads_r, _ = _dropout_grads(path, remat=True)
    # the forward is the same; the recomputed masks are not
    assert torch.equal(loss, loss_r)
    assert not all(torch.equal(a, b) for a, b in zip(grads, grads_r))


def _corpus(root):
    rng = np.random.default_rng(0)
    d = root / "wiki_section"
    d.mkdir()
    for split, n in (("train.jsonl", 6), ("dev.jsonl", 2), ("test.jsonl", 1)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(8, 14))
                sents = [" ".join(f"w{i}" for i in rng.integers(0, 50, size=rng.integers(3, 8)))
                         for _ in range(ns)]
                labels = [int(rng.random() < 0.25) for _ in range(ns - 1)] + [1]
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def test_finetune_cli_with_checkpointing_trains_the_same_weights(tmp_path):
    """run_finetune --gradient_checkpointing at the default dropout (0.1)
    trains to the same weights, bit for bit, as without it."""
    from spokennlp_tpu_torch.cli import run_finetune

    data = _corpus(tmp_path)
    argv = ["--data_dir", data, "--device", "cpu", "--hidden_size", "32",
            "--num_hidden_layers", "2", "--num_attention_heads", "2", "--intermediate_size", "64",
            "--max_seq_length", "64", "--num_train_epochs", "2", "--per_device_train_batch_size",
            "4", "--gradient_accumulation_steps", "1", "--do_train", "--do_da_ts", "--do_tssp",
            "--tssp_loss_weight", "1.0", "--cl_loss_weight", "0.5", "--cl_anchor_level",
            "eop_list", "--attention_impl", "train_fused"]
    plain = run_finetune.main(argv + ["--output_dir", str(tmp_path / "plain")])
    remat = run_finetune.main(argv + ["--output_dir", str(tmp_path / "remat"),
                                      "--gradient_checkpointing"])
    assert plain["train_steps"] == remat["train_steps"] >= 2
    plain = torch.load(tmp_path / "plain" / "final_model" / "model.pt", weights_only=True)
    remat = torch.load(tmp_path / "remat" / "final_model" / "model.pt", weights_only=True)
    assert plain.keys() == remat.keys()
    assert all(torch.equal(plain[k], remat[k]) for k in plain)
