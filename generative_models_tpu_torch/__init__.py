"""generative_models_tpu_torch — the PyTorch/CUDA port of
``generative_models_tpu`` for an NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
neither JAX nor anything of it. Its layout mirrors the reference's:

- ``config``  the same Config, variants and validation
- ``data``    MNIST loaders, the synthetic digits, the device pipeline
- ``ops``     activations, the fused linear, and the hand-written CUDA
              kernels (``csrc/``: whole-MLP forward and backward, the
              whole training chunk) with their plain PyTorch versions
- ``models``  the MLP stacks (generator, discriminator)
- ``losses``  loss-head specs and the registry (nsgan, mmgan so far)
- ``train``   optimizers, the train step and chunk, the Trainer
- ``utils``   checkpoints in the JAX package's layout, metrics, plots
- ``tools``   measurement scripts for the card (``chunk_phases``)
- ``cli``     ``python -m generative_models_tpu_torch --variant nsgan``

Entry points run on the card (``device="cuda"``) and raise without one;
the CPU runs only when asked for, and then the kernels' plain versions run.
"""

__version__ = "0.1.0"
