"""The reference's write gate, query DSL, retention, audit and hook cases
(tests/test_gate_query_policies.py, 73 tests) run on the port.

The port's gate, query, policies and hooks modules are copies of the
reference's, but for their imports; their cases run here against them
with the port's MemoryStorage, HashingEmbedder, CortexConfig and Cortex,
and the flat index on the CPU (TorchFlatIndex(device="cpu"), whose
search is the exact fp32 product, as the reference's is on the CPU).
Every assertion is the reference's: the port gives the reference's
results on the same inputs.
"""

from torch_reference_cases import port_cases

exec(port_cases("test_gate_query_policies.py", [
    (r"\bTpuFlatIndex\((\w+)\)", r'TpuFlatIndex(\1, device="cpu")'),
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
    (r"Cortex\.in_memory\(cfg\)", 'Cortex.in_memory(cfg, device="cpu")'),
]), globals())


def test_cases_run_on_the_port():
    for obj in (WriteGate, SchemaValidator, RetentionEngine, AuditLog,  # noqa: F821
                parse_and_compile, MemoryStorage, HashingEmbedder,  # noqa: F821
                TorchFlatIndex, HookRegistry, Node):  # noqa: F821
        assert obj.__module__.startswith("cortex_tpu_torch."), obj
