"""harl_tpu_torch — the PyTorch/CUDA port of harl_tpu.

Mirrors the JAX package's module layout (``utils``, ``ops``, ``models``,
``algos``, ``envs``, ``runners``) so each module's counterpart is easy to find.
It imports ``torch``, numpy and yaml only: nothing of JAX and nothing of
``harl_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``; the hand-written kernels live in ``csrc/`` and are built
with ``nvcc`` at first use (``ops/_build.py``).
"""
