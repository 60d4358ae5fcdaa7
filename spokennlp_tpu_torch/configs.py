"""Configuration dataclasses for spokennlp_tpu.

The port's own copy of ``spokennlp_tpu/configs.py`` (same behaviour; imports
only the port, numpy and the standard library).

One config stack replaces the reference's per-project argument schemas
(reference: emnlp2023-topic_segmentation/src/arguments.py:6-259,
mmvts/src/arguments.py, action-item-detection/script/run_classifier.py:42-210).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Architecture config for the shared transformer trunk.

    ``attention_type`` selects the token mixer:
      - "dense":           full bidirectional attention (BERT/ELECTRA/StructBERT)
      - "sliding_window":  local window + global-token attention (Longformer-style;
                           reference: longformer_for_ts.py:55-58)
      - "ponet":           PoNet multi-granularity pooling mixer (arXiv 2110.02442;
                           interface per alimeeting4mug/src/models/modeling_ponet.py:52)
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    # ELECTRA-style factorized embeddings: when set and != hidden_size, the
    # embedding tables use this width and a projection maps to hidden_size
    embedding_size: Optional[int] = None
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    hidden_act: str = "gelu"
    pad_token_id: int = 0
    attention_type: str = "dense"
    # attention implementation: "auto" picks the Pallas flash kernel on TPU
    # (segment-id masking, no materialized score matrix), einsum elsewhere.
    # Note: the flash path does not apply attention-prob dropout.
    # "fused" = one attention-block kernel + one MLP-block kernel per layer;
    # "stack" = the whole-stack megakernel (ops/pallas/stack_block.py) — one
    # pallas_call for all layers, hidden state resident in VMEM; bit-identical
    # to "fused" in quantized mode and ~6% faster at small batch (B<=32),
    # neutral at B=128 (measured v5e).
    attention_impl: str = "auto"  # auto | einsum | flash | pallas | fused | stack
    # W8A8 quantized projections (inference only): all dense projections
    # (fused QKV, attention out, MLP) run as int8 x int8 -> int32 Pallas
    # matmuls with per-token activation / per-channel weight scales and a
    # fused dequant epilogue (ops/pallas/int8_matmul.py). ~2x MXU rate over
    # bf16 on v5e; applied only when deterministic=True (rounding has no
    # gradient). "none" | "w8a8".
    quantize: str = "none"
    # rematerialize (jax.checkpoint) each transformer layer on the backward
    # pass: activations inside a layer are recomputed instead of stored,
    # cutting peak training memory from O(num_layers * L * (H + 4H + nh*L))
    # to O(num_layers * L * H) at ~1.3x forward FLOPs — the standard TPU
    # HBM-vs-FLOPs trade for long-context training (Longformer/BigBird 4096).
    # Inference paths ignore it (nothing is stored anyway).
    remat: bool = False
    # run the attention softmax in the compute dtype instead of float32.
    # bf16 softmax measured 32% faster attention on v5e (VPU exp is the
    # bottleneck at L=512); argmax-based inference is insensitive to the
    # precision loss. Default off for exact HF parity and stable training.
    softmax_in_compute_dtype: bool = False
    # sliding-window attention (Longformer-style)
    attention_window: int = 512
    # sliding-window implementation: "bias" materializes an (L, L) mask (fine
    # to ~1k tokens, exact HF semantics); "chunked" is the O(L * window)
    # banded implementation enabling 4096-token contexts; "auto" picks
    # chunked when L > 1024.
    sliding_window_impl: str = "auto"  # auto | bias | chunked | fused
    max_global_tokens: int = 16  # static cap for the chunked global path  # one-sided window is attention_window // 2
    # bigbird block-sparse attention (attention_type="bigbird"; reference
    # backbone: emnlp2023-topic_segmentation/src/models/bigbird_for_ts.py).
    # "bias" materializes the (L, L) mask (exact oracle, short L); "block"
    # is the O(L * K * block) gather path; "auto" picks block when L > 1024.
    bigbird_block_size: int = 64
    bigbird_num_global_blocks: int = 2
    bigbird_num_random_blocks: int = 3
    bigbird_seed: int = 0
    bigbird_impl: str = "auto"  # auto | bias | block | fused
    # ponet
    ponet_local_window: int = 3
    # GA granularity: the official/ModelScope PoNet computes the global-
    # aggregation attention PER HEAD (transpose_for_scores on dense_q/k/o,
    # einsum 'bdh,bdlh->bdl' with 1/sqrt(head_size) scaling); the paper-level
    # single-head formulation (this repo's original) is the False default.
    # Checkpoint conversion (hf_convert.ponet_to_encoder_params) sets True.
    ponet_ga_per_head: bool = False
    # GA cross-fusion partner: the shared global token g' multiplies
    # elementwise with this per-token projection ("q" per the paper's
    # formulation; "v" = the dense_o projection is the documented
    # alternative if checkpoint probing shows otherwise — offline-unresolved
    # ambiguity, see models/ponet.py docstring)
    ponet_ga_fuse: str = "q"
    # PoNet mixer path: "auto"/"xla" = the XLA formulation (measured fastest
    # at PoNet scale); "fused" = the one-kernel Pallas block (opt-in; its
    # segmented-scan rolls are slower at L=4096 — see ROUND1_NOTES.md)
    ponet_mixer_impl: str = "auto"  # auto | fused | xla
    # embedding variant: "absolute" learned positions (BERT family)
    position_embedding_type: str = "absolute"
    # position-id convention: "bert" = arange(L); "roberta" = offset past the
    # padding index, computed from the attention mask (Longformer/RoBERTa)
    position_style: str = "bert"
    # whether a pooler (CLS tanh dense) exists — needed for sequence classification
    add_pooler: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class TopicSegConfig:
    """Task config for coherence-enhanced topic segmentation.

    Mirrors the knobs of the reference LossCalculator/CSSL/TSSP stack
    (reference: emnlp2023-topic_segmentation/src/models/modules/{loss_calculator,
    cssl,tssp,utils}.py) without copying its architecture.
    """

    num_labels: int = 2  # label 0 = B-EOP (topic boundary), 1 = O
    num_tssp_labels: int = 3
    ts_score_predictor: str = "lt"  # "lt" linear head | "cos" adjacent-eop cosine
    ts_score_predictor_cos_temp: float = 1.0
    ts_loss_weight: float = 1.0
    cl_loss_weight: float = 0.5
    tssp_loss_weight: float = 1.0
    cl_temp: float = 0.1
    cl_anchor_level: str = "eop_list"  # eop_matrix | eop_list | eot_list
    cl_positive_k: int = 1
    cl_negative_k: int = 1
    focal_loss_gamma: float = 0.0
    weight_label_zero: float = 0.5  # CE class weight on label 0; 0.5 = unweighted
    do_da_ts: bool = False  # run the DA view through the encoder with ts loss
    do_tssp: bool = False
    tssp_ablation: str = "none"
    classifier_dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class WindowingConfig:
    """Self-adaptive sliding-window featurization config.

    Reference semantics: emnlp2023-topic_segmentation/src/
    ts_sentence_seq_labeling.py:814-918 (window loop, overlap rule).
    """

    max_seq_length: int = 512
    cls_token_id: int = 101
    pad_token_id: int = 0
    bos_token_id: int = 1  # [BOS] sentence marker prepended to every sentence
    label_eop: int = 0  # B-EOP
    label_o: int = 1  # O
    ignore_id: int = -100


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.0
    num_train_epochs: float = 5.0
    per_device_batch_size: int = 2
    gradient_accumulation_steps: int = 4
    max_grad_norm: float = 1.0
    seed: int = 42
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    log_every: int = 50
    eval_cnt: int = 5  # number of evals over training (reference eval_steps calc)
    checkpoint_dir: Optional[str] = None
    save_total_limit: int = 2
    # host featurization fan-out (the reference's datasets.map num_proc,
    # ts_sentence_seq_labeling.py:945-954)
    preprocessing_num_workers: int = 1
    # TensorBoard event dir (the reference's report_to tensorboard); None =
    # JSONL/stdout only
    tensorboard_dir: "Optional[str]" = None
    # SPMD mesh: data-parallel over all local devices by default (the
    # reference's torch.distributed.launch DDP, run_finetune.sh:61); set
    # model_parallel_size > 1 for a second tensor-parallel axis.
    model_parallel_size: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. data axis = DP, model axis = TP (optional >1)."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1
