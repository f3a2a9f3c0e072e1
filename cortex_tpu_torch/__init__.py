"""cortex_tpu_torch — the port of cortex_tpu to PyTorch and CUDA.

The JAX package `cortex_tpu` stays beside it as the reference. This
package reuses cortex_tpu's host modules that import without jax (node
types, errors, storage, hooks, the native re-rank) and ports the rest.
It never imports jax.

Ported so far: store -> search over the flat index (`[embedding] index
= "flat"`, the default), with the int8 candidate scan and the exact
fp32 re-rank as hand-written CUDA kernels (csrc/flat_scan.cu), and over
the IVF index (`index = "ivf"`), with the probed-block scan as one
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
