"""generative_models_tpu_torch — the PyTorch/CUDA port of
``generative_models_tpu`` for an NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
neither JAX nor anything of it. Its layout mirrors the reference's:

- ``config``  the same Config, variants and validation
- ``ops``     activations, the fused linear, and the hand-written CUDA
              kernels (``csrc/``) with their plain PyTorch versions
- ``models``  the MLP stacks (generator, discriminator)
- ``losses``  loss-head specs and the registry (nsgan, mmgan so far)
- ``utils``   loading the JAX package's checkpoints, sample grids
- ``train``   the Trainer (serving part so far)
- ``cli``     ``python -m generative_models_tpu_torch ... --sample-only``

Entry points run on the card (``device="cuda"``) and raise without one;
the CPU runs only when asked for, and then the kernels' plain versions run.
"""

__version__ = "0.1.0"
