"""gptq_v2_tpu_torch — the PyTorch/CUDA port of ``gptq_v2_tpu`` for NVIDIA H100.

GPTQ post-training quantization of dense Llama-family models plus W4A16
(or W4A8) serving of the result, in PyTorch, with the JAX package's Pallas kernels
rewritten by hand in CUDA C++ for Hopper (``csrc/``).  Module names mirror
``gptq_v2_tpu`` so each counterpart is easy to find:

  quant/      quantizer math, Hessian accumulation + inversion, GPTQ solver
  ops/        CUDA kernel wrappers (each beside its plain PyTorch version)
              and the packed low-bit weight format
  models/     functional Llama + safetensors reader/writer + HF loader
  graph.py    the quantization stages, from a torch.fx trace of the block
  pipeline.py block-sequential quantization pipeline (incremental,
              wave and per-stage paths)
  main.py     results.npz save/load
  serving/    packed model, contiguous and paged KV caches, decode and
              sampling, the continuous-batching engine
  serve.py    serving CLI

Entry points compute on ``device="cuda"`` unless the caller passes another
device.  Nothing here imports JAX or ``gptq_v2_tpu``.
"""

__version__ = "0.1.0"
