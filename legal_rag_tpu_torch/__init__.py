"""legal_rag_tpu_torch — the PyTorch + CUDA port of legal_rag_tpu.

Same layout as the JAX package, which stays the reference: each module
here has its counterpart at the same path under ``legal_rag_tpu``. The
port imports ``torch`` and never ``jax``, nor any module of the JAX
package: the pure-host modules it needs (``config``, ``utils.timing``,
``server.*``, ``ingest``) are copies of their own. The TPU kernels are
hand-written CUDA kernels under ``csrc/``, each beside a plain PyTorch
version that CPU tensors take.
"""

__version__ = "0.1.0"
