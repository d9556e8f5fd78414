"""The native (C++) host engine: ``vec_mujoco.cc``, built by ``build.py``."""
