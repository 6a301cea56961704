"""PyTorch/CUDA port of the JAX package ``repro`` (the model stack on top of
WTF).  It imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``."""
