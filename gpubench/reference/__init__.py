"""The plain references of the benchmark's configurations, one module a
configuration (``<config>.py``, loaded by its path), and the arithmetic
they share. Plain PyTorch in float32 with TF32 off: nothing here imports
JAX, the JAX package or anything of ``generative_models_tpu_torch``, and
nothing takes what the program made."""
