"""PyTorch/CUDA port of ``multivae_tpu``.

The JAX package ``multivae_tpu`` is the reference; this package mirrors its
module layout and public names. Plain tensor code is PyTorch; every kernel
the JAX package wrote in Pallas for the TPU is a hand-written CUDA kernel
here (``csrc/``), built with ``nvcc`` on first use.

Ported so far: the MMVAE DReG training path (data, MLP nets, K-sample ops,
the mixture log-density kernel, ``BaseTrainer``'s synchronous loop).
"""

__version__ = "0.1.0"
