"""Training loop for topic segmentation: epochs, the eval cadence,
checkpoints and best-metric retention, on one device or data parallel.

Counterpart of ``TopicSegTrainer`` in ``spokennlp_tpu/train/trainer.py``:

- eval every ``total_steps // eval_cnt`` optimizer steps (at least 40), the
  reference's cadence;
- metrics stream to a JSONL file and the log, one line per event, and with
  ``train_cfg.tensorboard_dir`` to TensorBoard scalars ``<event>/<name>``
  (``torch.utils.tensorboard``), as the JAX trainer writes them;
- checkpoints are ``torch.save`` files (model, optimizer, step, eval
  metrics) under ``train_cfg.checkpoint_dir``; the ``save_total_limit``
  best by ``metric_for_best`` are kept, as the JAX trainer's Orbax manager
  keeps them;
- ``restore_latest`` resumes from the newest kept checkpoint;
- inside a ``torch.distributed`` process group (data parallel, one process
  a card): the global batch is ``per_device_batch_size`` x world size, every
  rank builds the same batches from the same seed and trains on its rows
  (``parallel.mesh.shard_batch``; short batches repeat their last row
  first), the weights start from rank 0's; eval splits the windows over the
  ranks and gathers the predictions with ``allgather_ragged``, as JAX's
  trainer does; rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spokennlp_tpu_torch.configs import TopicSegConfig, TrainConfig, WindowingConfig
from spokennlp_tpu_torch.data.featurization import batches_from_docs, featurize_paired
from spokennlp_tpu_torch.eval import seg_metrics
from spokennlp_tpu_torch.parallel import dist as dist_lib
from spokennlp_tpu_torch.parallel import mesh as mesh_lib
from spokennlp_tpu_torch.train import optim
from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

logger = logging.getLogger("spokennlp_tpu_torch.trainer")


class MetricLogger:
    """JSONL metric stream (one line per event), the log, and with
    ``tensorboard_dir`` every numeric value of an event but its step, time
    and epoch as the scalar ``<event>/<name>`` at the event's step."""

    def __init__(self, path: Optional[str], tensorboard_dir: Optional[str] = None):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        self._tb = None
        if tensorboard_dir:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(tensorboard_dir)

    def log(self, event: Dict):
        event = {**event, "time": time.time()}
        line = json.dumps(event, default=float)
        logger.info(line)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self._tb is not None:
            step = int(event.get("step", 0))
            tag = event.get("event", "metrics")
            for k, v in event.items():
                if k not in ("event", "step", "time", "epoch") and isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{tag}/{k}", float(v), step)
            self._tb.flush()

    def close(self):
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class TopicSegTrainer:
    def __init__(
        self,
        model: torch.nn.Module,
        task_cfg: TopicSegConfig,
        train_cfg: TrainConfig,
        windowing_cfg: WindowingConfig,
        train_docs: Sequence[Dict],
        eval_docs: Optional[Sequence[Dict]] = None,
        metric_for_best: str = "f1",
        log_path: Optional[str] = None,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.task_cfg = task_cfg
        self.train_cfg = train_cfg
        self.wcfg = windowing_cfg
        self.train_docs = list(train_docs)
        self.eval_docs = list(eval_docs) if eval_docs else None
        self.metric_for_best = metric_for_best
        mesh_lib.check_model_parallel(train_cfg.model_parallel_size)
        self.rank, self.world_size = dist_lib.rank(), dist_lib.world_size()
        self.is_main = self.rank == 0
        self.metrics_log = MetricLogger(log_path if self.is_main else None,
                                        train_cfg.tensorboard_dir if self.is_main else None)
        self.batch_size = train_cfg.per_device_batch_size * self.world_size
        dp = dist_lib.data_parallel()
        if dp is not None:  # every rank starts from rank 0's weights
            dp.broadcast_([p.data for p in model.parameters()])

        n_windows = len(featurize_paired(
            self.train_docs, self.wcfg, np.random.default_rng(train_cfg.seed),
            task_cfg.tssp_ablation, num_proc=train_cfg.preprocessing_num_workers,
        ))
        steps_per_epoch = max(n_windows // self.batch_size, 1)
        self.total_steps = int(
            steps_per_epoch * train_cfg.num_train_epochs // train_cfg.gradient_accumulation_steps
        )
        self.eval_steps = max(self.total_steps // max(train_cfg.eval_cnt, 1), 40)
        self.optimizer = optim.make_optimizer(model, train_cfg, max(self.total_steps, 1))
        self.step_fn = make_topic_seg_train_step(model, task_cfg, self.optimizer,
                                                 seed=train_cfg.seed)
        self.checkpoint_dir = Path(train_cfg.checkpoint_dir) if train_cfg.checkpoint_dir else None

    # ------------------------------------------------------------------ train

    def train(self) -> Dict:
        cfg = self.train_cfg
        accum = max(cfg.gradient_accumulation_steps, 1)
        data_rng = np.random.default_rng(cfg.seed)
        step = self.optimizer.micro_step
        best = float("-inf")
        t_start = time.time()
        epoch = 0
        while step < self.total_steps * accum:
            epoch += 1
            # short final batches are padded by repetition (drop_last=False)
            for batch in batches_from_docs(
                self.train_docs, self.wcfg, self.task_cfg, self.batch_size, data_rng,
                drop_last=False, num_proc=cfg.preprocessing_num_workers,
            ):
                batch = mesh_lib.shard_batch(batch, self.rank, self.world_size)
                metrics = self.step_fn(batch_to_device(batch, self.device))
                step += 1
                # log and eval cadences count optimizer steps
                at_opt_boundary = step % accum == 0
                opt_step = step // accum
                if at_opt_boundary and opt_step % cfg.log_every == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    self.metrics_log.log({"event": "train", "step": opt_step, "epoch": epoch,
                                          **scalars})
                if self.eval_docs and at_opt_boundary and opt_step % self.eval_steps == 0:
                    eval_metrics = self.evaluate()
                    self.metrics_log.log({"event": "eval", "step": opt_step, **eval_metrics})
                    best = max(best, eval_metrics.get(self.metric_for_best, 0.0))
                    self._save(opt_step, eval_metrics)
                if step >= self.total_steps * accum:
                    break
        final = {
            "train_steps": step,
            "train_time_s": time.time() - t_start,
            "best_" + self.metric_for_best: best,
        }
        if self.eval_docs:
            final_eval = self.evaluate()
            final.update({f"final_{k}": v for k, v in final_eval.items()})
            self._save(step // accum, final_eval)
        self.metrics_log.log({"event": "train_end", **final})
        return final

    # ------------------------------------------------------------------- eval

    def evaluate(self, docs: Optional[Sequence[Dict]] = None) -> Dict:
        """Window-level eval: boundary precision/recall/F1 and Pk/WD over the
        labelled sentences of every window (the reference's compute_metrics).
        Each rank scores its block of the windows; the predictions are
        gathered in rank order (window order) on every rank."""
        from spokennlp_tpu_torch.data.windowing import stack_windows, window_document
        from spokennlp_tpu_torch.eval.inference import predict_cos_scores, predict_windows_scanned

        docs = docs if docs is not None else self.eval_docs
        if docs is None:
            logger.warning("evaluate() called with no eval docs; skipping")
            return {}
        windows = []
        for eid, doc in enumerate(docs):
            windows.extend(window_document(doc["sent_token_ids"], doc["labels"], self.wcfg, eid))
        if not windows:
            return {}
        start, end = mesh_lib.rank_rows(len(windows), self.rank, self.world_size)
        windows = windows[start:end]
        preds, refs = [], []
        # each rank scores its windows at the per-device batch size
        bs = self.train_cfg.per_device_batch_size
        batch = stack_windows(windows) if windows else None
        if batch is None:  # fewer windows than ranks: this rank scores none
            pass
        elif self.task_cfg.ts_score_predictor == "cos":
            # the linear head carries no ts gradient in cos mode: a slot of
            # eop_mask is predicted O (1) where its sigmoid-cos is above 0.5
            sims = predict_cos_scores(self.model, batch, bs,
                                      self.task_cfg.ts_score_predictor_cos_temp)
            for i in range(len(windows)):
                live = batch["eop_mask"][i].astype(bool)
                if live.any():
                    preds.append((sims[i][live] > 0.5).astype(int).tolist())
                    refs.append(batch["sent_labels"][i][live].astype(int).tolist())
        else:
            logits = predict_windows_scanned(self.model, batch, bs, gather_sents=True)
            for i in range(len(windows)):
                live = batch["sent_labels"][i] != -100
                if live.any():
                    preds.append(np.argmax(logits[i][live], -1).tolist())
                    refs.append(batch["sent_labels"][i][live].tolist())
        # every rank's windows, in window order (no-op on one process)
        preds = dist_lib.allgather_ragged(preds)
        refs = dist_lib.allgather_ragged(refs)
        prf = seg_metrics.boundary_prf(preds, refs)
        # label id 0 = B-EOP
        wm = seg_metrics.compute_window_metric(
            [[1 if v == 0 else 0 for v in p] for p in preds],
            [[1 if v == 0 else 0 for v in r] for r in refs],
        )
        return {
            "precision": prf["overall_precision"],
            "recall": prf["overall_recall"],
            "f1": prf["overall_f1"],
            "accuracy": prf["overall_accuracy"],
            "1-pk": wm["1-pk"],
            "1-wd": wm["1-wd"],
            "pk": wm["pk"],
            "wd": wm["wd"],
        }

    # ------------------------------------------------------------ checkpoints

    def _index(self, root: Path) -> list:
        path = root / "checkpoints.json"
        return json.loads(path.read_text()) if path.exists() else []

    def _save(self, step: int, eval_metrics: Dict):
        """Write ``step_<n>.pt`` and keep the ``save_total_limit`` best by
        ``metric_for_best`` (the newer on a tie); rank 0 writes, the others
        wait for it."""
        if self.checkpoint_dir is None:
            return
        if not self.is_main:
            dist_lib.barrier()
            return
        root = self.checkpoint_dir
        root.mkdir(parents=True, exist_ok=True)
        name = f"step_{step}.pt"
        tmp = root / f"{name}.tmp"
        torch.save({"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                    "step": step, "metrics": {k: float(v) for k, v in eval_metrics.items()}}, tmp)
        os.replace(tmp, root / name)
        entries = [e for e in self._index(root) if e["step"] != step]
        entries.append({"step": step, "file": name,
                        "score": float(eval_metrics.get(self.metric_for_best, float("-inf")))})
        entries.sort(key=lambda e: (e["score"], e["step"]), reverse=True)
        keep = max(self.train_cfg.save_total_limit, 1)
        for e in entries[keep:]:
            (root / e["file"]).unlink(missing_ok=True)
        (root / "checkpoints.json").write_text(json.dumps(entries[:keep], indent=2))
        dist_lib.barrier()

    def restore_latest(self, checkpoint_dir: Optional[str] = None) -> bool:
        """Resume from the newest kept checkpoint (under ``checkpoint_dir``
        when given); returns whether one was found."""
        root = Path(checkpoint_dir) if checkpoint_dir else self.checkpoint_dir
        entries = self._index(root) if root is not None else []
        if not entries:
            return False
        latest = max(entries, key=lambda e: e["step"])
        state = torch.load(root / latest["file"], map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        return True
