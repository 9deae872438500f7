// The bfloat16 instance of the mixture kernels: the kernels, plan and C
// entries of mixture.cu with z, mu, sig, mask, dz, dmu and dsig in bf16
// (out, logc, g and all arithmetic stay float). A source of its own so that
// nvcc builds the two element types in parallel; loaded by
// multivae_tpu_torch/ops/mixture.py for bf16 inputs (the trainer's
// mixed_precision).
#define MIXTURE_BF16
#include "mixture.cu"
