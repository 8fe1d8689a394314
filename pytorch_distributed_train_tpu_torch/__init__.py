"""PyTorch/CUDA port of the Llama serving path.

The JAX package ``pytorch_distributed_train_tpu`` is the reference; this
package keeps its own copies of what it needs and imports nothing of it.
Entry points take ``device=`` and default to ``"cuda"``; the plain PyTorch
versions of the kernels run only for tensors that lie on the CPU.
"""
