"""cortex_tpu_torch — the port of cortex_tpu to PyTorch and CUDA.

The JAX package `cortex_tpu` stays beside it as the reference. This
package reuses cortex_tpu's host modules that import without jax (node
types, errors, storage, hooks, the native re-rank) and ports the rest.
It never imports jax.

Ported so far: the IVF store -> search slice (`[embedding] index =
"ivf"`), with the probed-block scan as a hand-written CUDA kernel
(csrc/ivf_gather.cu).
"""

__all__ = ["Cortex"]


def __getattr__(name):
    # Lazy import: keep `import cortex_tpu_torch` light (no torch).
    if name == "Cortex":
        from .api import Cortex
        return Cortex
    raise AttributeError(
        f"module 'cortex_tpu_torch' has no attribute {name!r}")
