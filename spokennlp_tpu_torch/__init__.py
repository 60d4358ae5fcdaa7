"""spokennlp_tpu_torch: the PyTorch and CUDA port of spokennlp_tpu.

The package mirrors ``spokennlp_tpu``'s layout (``models/encoder.py``,
``ops/cuda/attention_block.py``, ``eval/inference.py``,
``cli/run_inference.py``, ...), so each module's JAX counterpart sits at the
same path there. Host code that imports neither jax nor flax (configs,
featurizers, corpora, tokenization, segmentation metrics) is imported from
``spokennlp_tpu`` rather than copied. The Pallas kernels become CUDA C++
kernels for Hopper under ``csrc/``, built at first use (``ops/cuda/build.py``).
"""
