"""spokennlp_tpu_torch: the PyTorch and CUDA port of spokennlp_tpu.

The package mirrors ``spokennlp_tpu``'s layout (``models/encoder.py``,
``ops/cuda/attention_block.py``, ``eval/inference.py``,
``cli/run_inference.py``, ...), so each module's JAX counterpart sits at the
same path there. The port imports nothing of
``spokennlp_tpu``: it keeps its own copies of the host modules it needs
(configs, featurizers, augmentation, corpora, tokenization, segmentation
metrics, the CLI flag groups), with the same behaviour. The Pallas kernels become CUDA C++
kernels for Hopper under ``csrc/``, built at first use (``ops/cuda/build.py``).
"""
