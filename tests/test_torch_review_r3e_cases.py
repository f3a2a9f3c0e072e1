"""The reference's round-3e review cases (tests/test_review_r3e.py) on the
port: a failed index write, a torn delta, stores and config, every
Cortex on the CPU (device="cpu"); the flat index the cases patch is the
port's TorchFlatIndex."""

from torch_reference_cases import port_cases

exec(port_cases("test_review_r3e.py", [
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
], cpu_calls=(r"\bCortex\.open",)), globals())


def test_cases_run_on_the_port():
    cx = Cortex.in_memory(device="cpu")  # noqa: F821
    assert type(cx.index).__name__ == "TorchFlatIndex"
    cx.close()
