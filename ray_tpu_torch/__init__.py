"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside the JAX package ``ray_tpu``; it imports
``torch`` and never ``jax`` or ``ray_tpu``. Module names mirror the JAX
package (``models.transformer``, ``ops.flash_attention``,
``serve.llm_engine``, ...). Every Pallas kernel of the JAX package becomes a
hand-written Hopper kernel under ``ops/csrc/``, built at first use into
``ray_tpu_torch/_build/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
