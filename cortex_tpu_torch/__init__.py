"""cortex_tpu_torch — the port of cortex_tpu to PyTorch and CUDA.

The JAX package `cortex_tpu` stays beside it as the reference. This
package imports nothing of it, and never imports jax. The host modules
it needs are copies kept under the reference's names: `errors`,
`types`, `hooks`, `storage` (byte-for-byte the reference's, so a
database written by one package opens in the other), the graph
engine's host modules (`graph/`), and the native exact re-rank, BFS
and components (`native/`).

Ported so far: store -> search over the flat index (`[embedding] index
= "flat"`, the default), with the int8 candidate scan and the exact
fp32 re-rank as hand-written CUDA kernels (csrc/flat_scan.cu), and over
the IVF index (`index = "ivf"`), with the probed-block scan as one
(csrc/ivf_gather.cu); edges, the graph engine and hybrid search, whose
proximity leg walks the device graph mirror with two more
(csrc/graph_bfs.cu: the frontier walk and the min-plus relaxation); the
auto-linker with edge decay (csrc/decay_sweep.cu); the text encoder
(models/: the BERT tower of BGE-small-en-v1.5, its WordPiece tokenizer
and the npz of converted weights), whose residual + LayerNorm and masked
attention are two more (csrc/encoder_rows.cu, csrc/encoder_attn.cu);
and the host services, copies of the reference's modules: the write
gate (`gate/`, its conflict check a search of the index on the device),
briefings (`briefing/`), retention and the audit log (`policies/`), the
prompt subsystem (`prompt/`), the query DSL (`query/`) and the `kinds`
and `relations` names, with retention eligibility over packed node
arrays as one more kernel (csrc/retention_eligibility.cu).
"""

from . import kinds, relations
from .errors import (CortexError, DuplicateEdge, EdgeNotFound, GateRejection,
                     InvalidEdge, NodeNotFound, QueryParseError,
                     ValidationError)
from .types import Edge, EdgeProvenance, Node, Source

__all__ = [
    "kinds", "relations",
    "Node", "Edge", "EdgeProvenance", "Source",
    "CortexError", "ValidationError", "NodeNotFound", "EdgeNotFound",
    "DuplicateEdge", "InvalidEdge", "GateRejection", "QueryParseError",
    "Cortex",
]


def __getattr__(name):
    # Lazy import: keep `import cortex_tpu_torch` light (no torch).
    if name == "Cortex":
        from .api import Cortex
        return Cortex
    raise AttributeError(
        f"module 'cortex_tpu_torch' has no attribute {name!r}")
