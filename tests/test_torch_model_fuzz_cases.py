"""The reference's model fuzzers (tests/test_model_fuzz.py) on the port:
Cortex against a dict of live nodes, the graph engine against a BFS
oracle, the query DSL, the decay sweep (D1's plain version) against the
numpy sweep and a scalar oracle, filtered flat search against a numpy
oracle and the linker, every Cortex and index on the CPU.

Rewrites: the decay fuzzer passes the sweep torch tensors
(torch.as_tensor) where the reference passes jax arrays (jnp.asarray),
and numpy float32 scalars for jnp.float32; the linker comes from the
port's run of the reference's linker cases (test_torch_linker_cases.py),
not from tests/test_linker.py."""

from torch_reference_cases import port_cases

exec(port_cases("test_model_fuzz.py", [
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
    (r"import jax\.numpy as jnp\n", "import torch\n"),
    (r"jnp\.asarray", "torch.as_tensor"),
    (r"jnp\.float32", "np.float32"),
    (r"from test_linker import", "from test_torch_linker_cases import"),
], cpu_calls=(r"\bTorchFlatIndex", r"\bCortex\.in_memory")), globals())


def test_cases_run_on_the_port():
    from test_torch_linker_cases import build_linker
    linker, *_ = build_linker()
    assert type(linker).__module__ == "cortex_tpu_torch.linker.auto_linker"
    assert Cortex.__module__ == "cortex_tpu_torch.api"  # noqa: F821
