"""PyTorch/CUDA port of ``multivae_tpu``.

The JAX package ``multivae_tpu`` is the reference; this package mirrors its
module layout and public names. Plain tensor code is PyTorch; every kernel
the JAX package wrote in Pallas for the TPU is a hand-written CUDA kernel
here (``csrc/``), built with ``nvcc`` on first use.

Ported so far: the MMVAE DReG/IWAE training path (data, MLP nets,
K-sample ops, the mixture log-density kernel, ``BaseTrainer``'s synchronous
loop) and MVTCAE end to end (PoE ops, the PolyMNIST conv nets, training on
incomplete data, encode / decode / predict / generate_from_prior, the
K-sample joint NLL and the conditional NLL).
"""

__version__ = "0.1.0"
