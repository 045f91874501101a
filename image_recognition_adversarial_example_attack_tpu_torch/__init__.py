"""PyTorch/CUDA port of the adversarial attack & defense framework.

The JAX package ``image_recognition_adversarial_example_attack_tpu`` is the
reference; this package mirrors its layout and public functions (NHWC
float32 batches in [0,1]) and imports nothing of it, nor JAX.  Its entry
points run on a CUDA device unless the caller asks for the CPU, and its
Pallas TPU kernels are hand-written CUDA kernels (``csrc/``, ``kernels/``).
"""

__version__ = "0.1.0"
