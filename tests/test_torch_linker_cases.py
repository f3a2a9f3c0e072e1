"""The reference's auto-linker cases (tests/test_linker.py) on the port:
rules, dedup, the incremental scan, hybrid search with the graph mirror,
the linker on SQLite, every flat index, graph mirror and Cortex on the
CPU. test_torch_model_fuzz_cases.py takes its build_linker from here."""

from torch_reference_cases import port_cases

exec(port_cases("test_linker.py", [
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
], cpu_calls=(r"\bTorchFlatIndex", r"\bDeviceGraphMirror",
              r"\bCortex\.in_memory")), globals())


def test_cases_run_on_the_port():
    linker, storage, idx, emb = build_linker()  # noqa: F821
    for obj in (linker, storage, idx, emb):
        assert type(obj).__module__.startswith("cortex_tpu_torch."), obj
    assert str(idx._corpus._device) == "cpu"
