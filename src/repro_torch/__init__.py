"""PyTorch/CUDA port of the BSO-SL swarm trainer.

A second package beside the JAX reference ``repro``; its module layout
mirrors that package so each counterpart is found at the same path.
It imports ``torch`` and never ``jax``, and nothing of ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
