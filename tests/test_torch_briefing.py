"""The reference's briefing cases (tests/test_briefing.py, 22 tests) run
on the port.

The port's briefing modules are copies of the reference's, but for
their imports; their cases run here with the port's MemoryStorage,
GraphEngine, HashingEmbedder, HybridSearch, the graph mirror and the
flat index on the CPU. Every assertion is the reference's.
"""

from torch_reference_cases import port_cases

exec(port_cases("test_briefing.py", [
    (r"\bTpuFlatIndex\((\w+)\)", r'TpuFlatIndex(\1, device="cpu")'),
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
    (r"DeviceGraphMirror\(self\.graph\.cache\)",
     'DeviceGraphMirror(self.graph.cache, device="cpu")'),
]), globals())


def test_cases_run_on_the_port():
    w = World()  # noqa: F821
    for obj in (w.engine, w.s, w.idx, w.graph, w.mirror, w.hybrid,
                w.version, w.emb):
        assert type(obj).__module__.startswith("cortex_tpu_torch."), obj
    assert str(w.idx._corpus._device) == "cpu"
