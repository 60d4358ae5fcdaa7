"""What each rank runs in tests/test_torch_dist.py's two gloo processes
(``spokennlp_tpu_torch.dryrun.run_workers``): one data-parallel train step
with list-mode CSSL, ``allgather_ragged``, the engine's scorer, and the two
CLIs inside the process group. Everything is built from seeds, so the
single-process reference in the test process sees the same weights and
batches."""

import numpy as np

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64, add_pooler=False, hidden_dropout=0.0,
            attention_dropout=0.0)
WCFG = dict(max_seq_length=64, cls_token_id=2, pad_token_id=0, bos_token_id=1)
GLOBAL_BATCH = 4


def docs(seed=0, n_docs=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_docs):
        ns = int(rng.integers(6, 18))
        labels = [int(rng.random() < 0.3) for _ in range(ns - 1)] + [1]
        out.append({"sent_token_ids": [rng.integers(5, 120, size=rng.integers(2, 7)).tolist()
                                       for _ in range(ns)], "labels": labels})
    return out


def configs():
    from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig, WindowingConfig

    task = TopicSegConfig(cl_anchor_level="eop_list", cl_loss_weight=0.5, tssp_loss_weight=1.0,
                          do_tssp=True, do_da_ts=True, classifier_dropout=0.0,
                          weight_label_zero=0.3)
    return EncoderConfig(**TINY), task, WindowingConfig(**WCFG)


def global_batch():
    """The first global batch of list-mode CSSL (cssl_* index tensors over
    all its rows)."""
    from spokennlp_tpu_torch.data.featurization import batches_from_docs

    _, task, wcfg = configs()
    return next(batches_from_docs(docs(), wcfg, task, GLOBAL_BATCH, np.random.default_rng(0)))


def model():
    import torch

    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

    enc, task, _ = configs()
    return TopicSegModel(enc, task, generator=torch.Generator().manual_seed(0))


def step(world=1, rank=0):
    """One train step on this rank's rows: the metrics and the updated
    parameters' sum of squares."""
    import torch

    from spokennlp_tpu_torch.configs import TrainConfig
    from spokennlp_tpu_torch.parallel.mesh import shard_batch
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

    _, task, _ = configs()
    m = model()
    opt = optim.make_optimizer(m, TrainConfig(gradient_accumulation_steps=1, max_grad_norm=0.5),
                               10)
    metrics = make_topic_seg_train_step(m, task, opt)(
        batch_to_device(shard_batch(global_batch(), rank, world), torch.device("cpu")))
    out = {k: float(v) for k, v in metrics.items()}
    out["params"] = {n: p.detach().double().pow(2).sum().item() for n, p in m.named_parameters()}
    return out


def scores(world=1, rank=0):
    """make_predict_fn's logits on 4 rows, then the engine's per-document
    scores (run_topic_seg_inference)."""
    from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
    from spokennlp_tpu_torch.eval.inference import make_predict_fn, run_topic_seg_inference

    _, _, wcfg = configs()
    m = model().eval()
    b = window_documents_stacked(docs(1), wcfg)
    logits = make_predict_fn(m)(*(b[k][:4] for k in ("input_ids", "attention_mask",
                                                       "token_type_ids")))
    out = run_topic_seg_inference(m, docs(1), wcfg, batch_size=2, threshold=0.5)
    return {"logits": logits.numpy().tolist(),
            "per_doc": [d["scores"].tolist() for d in out["per_doc"]],
            "metrics": {k: float(v) for k, v in out["metrics"].items()}}


def worker(payload):
    from spokennlp_tpu_torch.cli import run_finetune, run_inference
    from spokennlp_tpu_torch.parallel import dist

    world, rank = dist.world_size(), dist.rank()
    res = {"step": step(world, rank),
           "ragged": dist.allgather_ragged([[rank] * k for k in range(rank + 2)]),
           "scores": scores(world, rank)}
    flags = payload["flags"]
    res["finetune"] = run_finetune.main(flags + ["--output_dir", payload["out"] + "/ft"])
    inf = run_inference.main(flags + ["--output_dir", payload["out"] + "/inf"])
    res["inference"] = {k: float(v) for k, v in inf["metrics"].items()}
    return res


# --------------------------------------------------------------------------
# tests/test_torch_sld_dist.py, test_torch_mmvts_dist.py and
# test_torch_model_parallel.py: what their gloo ranks run


def sld_worker(payload):
    """SLD data parallel: the step (dryrun.sld_step), its planted per-rank
    mean, then run_sld inside the group."""
    from spokennlp_tpu_torch import dryrun
    from spokennlp_tpu_torch.cli import run_sld

    res = {"step": dryrun.sld_step(dryrun.SLD_TINY),
           "fault": dryrun.sld_step({**dryrun.SLD_TINY, "fault": "per_rank_mean"})}
    res["cli"] = run_sld.main(payload["flags"] + ["--output_dir", payload["out"]])
    return res


def mmvts_worker(payload):
    """MMVTS on two ranks: the step at mp 1 and 2 (dryrun.mmvts_step), the
    three planted per-rank shortcuts, then run_finetune_multimodal inside
    the group at mp 1 and 2."""
    from spokennlp_tpu_torch import dryrun
    from spokennlp_tpu_torch.cli import run_finetune_multimodal

    tiny = dryrun.MMVTS_TINY
    res = {f"mp {mp}": dryrun.mmvts_step({**tiny, "mp": mp}) for mp in (1, 2)}
    for fault in ("per_rank_mean", "per_rank_capacity", "per_rank_topic_ids"):
        res[fault] = dryrun.mmvts_step({**tiny, "fault": fault})
    for name, extra in payload["clis"].items():
        res[name] = run_finetune_multimodal.main(
            payload["flags"] + extra + ["--output_dir", f"{payload['out']}/{name}"])
    return res


def mp_worker(payload):
    """The model axis: the topic-segmentation step on both paths of
    dryrun.MP_IMPLS (and its gradient norm counted on each rank's shards
    alone, the planted fault), then the CLIs with --model_parallel_size 2
    and a native checkpoint through the mesh both ways."""
    from spokennlp_tpu_torch import dryrun
    from spokennlp_tpu_torch.cli import (
        common, run_finetune, run_finetune_multimodal, run_inference,
    )
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.train import train_step

    batch = dryrun.synthetic_batch(payload["rows"])
    res = {f"{trunk} {impl}": dryrun.train_step_metrics(trunk, batch, impl, 2)
           for trunk in dryrun.MP_TRUNKS for impl in dryrun.MP_IMPLS}
    real = train_step.global_norm
    train_step.global_norm = lambda grads, params=(): real(grads)  # each rank's shards alone
    try:
        res["fault"] = dryrun.train_step_metrics("dense", batch, "einsum", 2)
    finally:
        train_step.global_norm = real
    for name, flags in payload.get("clis", {}).items():
        if name == "inference":
            res[name] = {k: float(v) for k, v in run_inference.main(flags)["metrics"].items()}
        else:
            res[name] = (run_finetune_multimodal if name == "mmvts" else run_finetune).main(flags)
    if "checkpoint_in" in payload:  # a whole checkpoint into the sharded model, and back out
        enc, task, _ = configs()
        import torch

        from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

        model = common.place_on_mesh(
            TopicSegModel(enc, task, generator=torch.Generator().manual_seed(0)), 2)
        params, _ = checkpoint_io.load_checkpoint(payload["checkpoint_in"])
        common.load_pretrained_into(model, params)
        state = checkpoint_io.model_state(model)
        if dist.rank() == 0:
            checkpoint_io.save_checkpoint(payload["checkpoint_out"],
                                          checkpoint_io.params_from_state_dict(state))
        res["sharded_params"] = sum(hasattr(p, "model_shard") for p in model.parameters())
    return res
