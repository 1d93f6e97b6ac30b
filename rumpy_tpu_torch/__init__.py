"""rumpy_tpu_torch — the PyTorch/CUDA port of rumpy_tpu.

The same super-resolution framework, written in PyTorch for an NVIDIA
H100. Public functions keep the JAX package's NHWC layout; inside, modules
run on NCHW-shaped tensors in ``torch.channels_last`` memory, so cuDNN
convolutions and the hand-written CUDA kernels share one buffer. The Pallas
TPU kernels of the JAX package become CUDA kernels under ``csrc/``, built
at first use. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
